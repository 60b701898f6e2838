"""Protected training of the ssm family (xlstm-125m: chunkwise mLSTM with
its chunk state carried, S = 16 at a reduced chunk of 8, and the sLSTM
token loop, both under autograd), held against the JAX trainer as
`test_torch_train_families.py` holds moe and hybrid (adamw); an L2 chain
rollback of the same grads fault against JAX's; and the training launcher
with `--arch` set to each family, at smoke size on the CPU."""
import contextlib
import io
import sys

import pytest
import torch

from repro_torch.launch import train as launch_train

from test_torch_train_families import (BACKENDS, Family, bitwise,
                                       check_at_rest_fault, check_clean,
                                       check_grads_fault, same_stream)

torch.set_num_threads(1)

ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    return Family(ARCH, tmp_path_factory)


@pytest.mark.parametrize("backend", BACKENDS)
def test_clean_training_matches_jax(fam, backend):
    check_clean(fam, backend)


@pytest.mark.parametrize("backend", ["sequential", "fused"])
def test_grads_fault_recovers_as_jax(fam, backend):
    check_grads_fault(fam, backend)


def test_hybrid_catches_at_rest_fault_as_jax(fam):
    check_at_rest_fault(fam)


def test_l2_chain_rollback_as_jax(fam):
    """L2 (Alg. 1, the chain of dual-state versions): the grads fault at
    step 3 rolls back to the version of step 2 as JAX's does, and the run
    ends bitwise equal to the clean sequential run."""
    rep, _ = fam.run("torch", "sequential", "grads", level=2)
    jrep, _ = fam.run("jax", "sequential", "grads", level=2)
    same_stream(rep, jrep)
    assert [(e.step, e.boundary, e.effect) for e in rep.detections] == \
        [(3, "commit", "TDC")]
    assert [(r["kind"], r["step"], r["rollbacks"])
            for r in rep.recoveries] == [("restore", 2, 1)]
    assert bitwise(rep, fam.run("torch", "sequential")[0])


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
                                  "internvl2-2b", "xlstm-125m",
                                  "seamless-m4t-medium"])
def test_launcher_trains_each_family(tmp_path, monkeypatch, arch):
    """`python -m repro_torch.launch.train --arch <family> --device cpu`:
    the reduced config trains 4 steps at L3 and, with `--inject-step 3`,
    the launcher's grads fault (element 11 of gradient leaf 3) is detected
    at the commit and restored from step 2. xlstm's leaf 3 (the reduced
    mLSTM forget-gate bias) holds 8 elements, so its run is clean."""
    fault = arch != "xlstm-125m"
    argv = ["train", "--arch", arch, "--device", "cpu", "--steps", "4",
            "--level", "3", "--ckpt-interval", "2",
            "--workdir", str(tmp_path / "wd")]
    if fault:
        argv += ["--inject-step", "3"]
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main()
    text = out.getvalue()
    if fault:
        assert "steps=4 detections=1 recoveries=1 ckpts=2" in text
        assert "fault detected at step 3 (boundary=commit, TDC)" in text
        assert "'kind': 'restore', 'step': 2" in text
    else:
        assert "steps=4 detections=0 recoveries=0 ckpts=2 stopped=False" \
            in text
