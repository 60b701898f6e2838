"""The port's planning tools against the reference's:

  * `configs`: SHAPES, SHAPE_BY_NAME and `shape_applicable`'s verdict and
    reason for every arch x shape;
  * `launch/input_specs.py`: the batch, decode, train-state and
    serve-param specs of every assigned arch at full size (`meta`
    tensors), their leaves' shapes and dtypes equal to the reference's
    `ShapeDtypeStruct`s and their logical axes equal, leaf for leaf; each
    spec tree resolves over a one-card mesh to whole leaves;
  * `launch/dryrun.py::run_cell`: the fields
    `tests/test_multidevice.py::test_dryrun_cell_small_arch` checks
    (xlstm-125m at decode_32k: ok, fits the card, a dominant term), a
    skipped cell's reason, the CLI's JSON, and on a reduced qwen2-0.5b
    training cell the state bytes equal to a built trainer's state
    (one state, and the sequential dual's two) and the activation bytes
    in the order full < minimal < none."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as jshape_applicable
from repro.launch import input_specs as jispec

from repro_torch import tree as tree_util
from repro_torch.configs import (SHAPE_BY_NAME, SHAPES, RunConfig,
                                 SedarConfig, ShapeSpec, TrainConfig,
                                 get_config, list_archs, reduce_for_smoke,
                                 shape_applicable)
from repro_torch.configs.registry import ASSIGNED_ARCHS
from repro_torch.launch import dryrun
from repro_torch.launch import input_specs as ispec
from repro_torch.runtime.train import SedarTrainer
from repro_torch.sharding import Resolver, ShardingRules

torch.set_num_threads(1)

DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int32: "int32"}


def test_shapes_equal_the_reference():
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in JSHAPES]
    assert set(SHAPE_BY_NAME) == {s.name for s in JSHAPES}


@pytest.mark.parametrize("arch", list_archs())
def test_shape_applicable_equals_the_reference(arch):
    for s, js in zip(SHAPES, JSHAPES):
        assert shape_applicable(get_config(arch), s) == \
            jshape_applicable(jget_config(arch), js)


def _flat(tree, jax_tree=False):
    """[(path, leaf)] with the axes tuples as leaves."""
    if jax_tree:
        return [(jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, tuple))[0]]
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + f"[{k!r}]")
        else:
            out.append((path, node))
    walk(tree, "")
    return out


def _same(specs, axes, jspecs, jaxes):
    got = [(p, tuple(t.shape), DTYPES[t.dtype]) for p, t in _flat(specs)]
    want = [(p, tuple(s.shape), str(s.dtype)) for p, s in
            _flat(jspecs, jax_tree=True)]
    assert got == want
    assert _flat(axes) == _flat(jaxes, jax_tree=True)
    assert all(t.device.type == "meta" for _, t in _flat(specs))
    # one card: every leaf whole
    res = Resolver({"data": 1, "model": 1}, ShardingRules())
    specs_ = ispec.shardings(res, specs, axes)
    assert all(all(e is None for e in sp) for _, sp in _flat(specs_))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    _same(*ispec.train_state_specs(cfg), *jispec.train_state_specs(jcfg))
    _same(*ispec.serve_param_specs(cfg), *jispec.serve_param_specs(jcfg))
    for s, js in zip(SHAPES, JSHAPES):
        _same(*ispec.batch_specs(cfg, s), *jispec.batch_specs(jcfg, js))
        if s.kind == "decode" and shape_applicable(cfg, s)[0]:
            _same(*ispec.decode_specs(cfg, s), *jispec.decode_specs(jcfg, js))


def test_dryrun_cell_small_arch(tmp_path):
    cell = dryrun.run_cell("xlstm-125m", "decode_32k", "baseline",
                           str(tmp_path))
    assert cell["status"] == "ok", cell.get("error")
    assert cell["memory"]["fits_80GB"]
    assert cell["memory"]["max_batch"] >= cell["memory"]["batch"] == 128
    assert cell["roofline"]["dominant"] in ("compute", "memory")
    assert cell["flops"]["total"] > 0 and cell["params"] > 0
    skipped = dryrun.run_cell("qwen2-0.5b", "long_500k", "baseline")
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == shape_applicable(
        get_config("qwen2-0.5b"), SHAPE_BY_NAME["long_500k"])[1]


def test_dryrun_cli_writes_the_cell(tmp_path):
    dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    cell = json.loads((tmp_path / "xlstm-125m__decode_32k__baseline.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["device"]["hbm_bytes"] == 80e9


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_util.leaves(tree))


def test_train_cell_state_bytes_equal_the_trainers(tmp_path):
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    shape = ShapeSpec("train_small", "train", 32, 4)
    cells = {(f, r): dryrun.run_cell(
                 "qwen2-0.5b", shape, f,
                 cfg=dataclasses.replace(cfg, remat=r))
             for f in ("baseline", "sedar") for r in ("none", "full")}
    for backend, flavor in (("none", "baseline"), ("sequential", "sedar")):
        tr = SedarTrainer(RunConfig(model=cfg, train=TrainConfig(
            global_batch=4, seq_len=32, steps=1), sedar=SedarConfig(
                level=1, replication=backend)), str(tmp_path / backend),
            notify=lambda e: None, device="cpu")
        state = tr.init_state(seed=0)
        mem = cells[flavor, "full"]["memory"]
        assert mem["state_bytes"] == _nbytes(state)
        assert mem["grads_bytes"] == _nbytes(state["params"])
        resident = _nbytes(tr.init_dual(seed=0))
        assert mem["resident_bytes"] - mem["ring_slot_bytes"] == resident
    act = {r: dryrun.run_cell("qwen2-0.5b", shape, "baseline",
                              cfg=dataclasses.replace(cfg, remat=r)
                              )["memory"]["activation_bytes_per_seq"]
           for r in ("none", "minimal", "full")}
    assert act["full"] < act["minimal"] < act["none"]
    assert cells["sedar", "full"]["memory"]["peak_bytes"] > \
        cells["baseline", "full"]["memory"]["peak_bytes"]
    assert np.isclose(cells["baseline", "none"]["flops"]["model_flops"],
                      cells["baseline", "full"]["flops"]["model_flops"])
