"""Protected training of the hybrid (recurrentgemma-2b: RG-LRU blocks and
local attention, whose reduced window of 8 the 16-token batch exceeds)
and vlm (internvl2-2b: stub patch embeddings before the tokens) families,
held against the JAX trainer as `test_torch_train_families.py` holds moe
and audio (the same checks; recurrentgemma with sgdm, internvl2 with
adamw), and F4's regression test for the vlm's patch embeddings."""
import pytest
import torch

from repro_torch import tree as tree_util

from test_torch_train_families import (BACKENDS, Family,
                                       check_at_rest_fault, check_clean,
                                       check_frontend_batch,
                                       check_grads_fault)

torch.set_num_threads(1)

ARCHS = ("recurrentgemma-2b", "internvl2-2b")


@pytest.fixture(scope="module")
def fams(tmp_path_factory):
    return {a: Family(a, tmp_path_factory) for a in ARCHS}


def test_trainer_batch_keeps_frontend_embeds(fams):
    check_frontend_batch(fams["internvl2-2b"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_clean_training_matches_jax(fams, arch, backend):
    check_clean(fams[arch], backend)


@pytest.mark.parametrize("backend", ["sequential", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_fault_recovers_as_jax(fams, arch, backend):
    check_grads_fault(fams[arch], backend)


@pytest.mark.parametrize("arch", ARCHS)
def test_hybrid_catches_at_rest_fault_as_jax(fams, arch):
    check_at_rest_fault(fams[arch])


def test_frontend_grads_reach_the_patch_positions(fams):
    """internvl2's loss reads the patch embeddings: the same step on zeroed
    embeddings (what the trainer computed before F4 was repaired) gives
    another loss and other grads."""
    fam = fams["internvl2-2b"]
    tr = fam.trainer("torch", "zeroed", "none")
    params = fam.state("torch")["params"]
    batch = tr.batch(0)
    loss, grads = tr.loss_and_grads(params, batch)
    zloss, zgrads = tr.loss_and_grads(
        params, dict(batch, frontend_embeds=torch.zeros_like(
            batch["frontend_embeds"])))
    assert float(loss) != float(zloss)
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_util.leaves(grads), tree_util.leaves(zgrads)))
