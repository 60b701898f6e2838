"""F7: the port's `RunConfig` is the reference's field for field and in the
reference's order (`model, mesh, train, serve, sedar`), so a positional
construction means the same run in both packages, and the mesh shape has
one source, `RunConfig.mesh` (the trainer's check of its process groups
is in `tests/test_torch_mesh.py::test_model_axis_and_a_missing_mesh_raise`)."""
import dataclasses

import pytest

from repro.configs import base as jbase

from repro_torch.configs import base as tbase
from repro_torch.configs import get_config


@pytest.mark.parametrize("name", ["RunConfig", "MeshConfig", "TrainConfig",
                                  "ServeConfig", "SedarConfig"])
def test_config_fields_in_the_reference_order(name):
    want = [f.name for f in dataclasses.fields(getattr(jbase, name))]
    got = [f.name for f in dataclasses.fields(getattr(tbase, name))]
    assert got == want


def test_run_config_positional_mesh_is_the_second_field():
    cfg = get_config("qwen2-0.5b")
    mesh = tbase.MeshConfig(shape=(2, 2), axis_names=("data", "model"))
    rc = tbase.RunConfig(cfg, mesh)
    assert rc.mesh is mesh and rc.train == tbase.TrainConfig()
