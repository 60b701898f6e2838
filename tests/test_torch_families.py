"""The port's moe, hybrid (RG-LRU + local attention), vlm, ssm (xLSTM) and
audio (encoder-decoder) families against the JAX reference, on the same
params (carried across by `bridge.params_from_numpy`) at reduce_for_smoke
size in f32: the loss (moe with `moe_aux` and `moe_drop_frac`), prefill
logits, 4 decode steps of logits and every cache leaf (xlstm at S = 16
with `mlstm_chunk` 8, so two chunks run); the MoE layer at a token count
where tokens drop (the drop fraction equal, not close); the RG-LRU scan;
the chunkwise mLSTM, an sLSTM block and an encoder layer; K2's plain
version at the families' head dims 128 and 256 against the Pallas kernel
in interpret mode; and the port's ring-buffer window cache against its own
full forward at prompt lengths that are not a multiple of the window (the
reference's prefill misplaces the ring there, so no JAX case uses them).

Tolerances: 1e-4 (abs and rel) for model outputs (the same math with
another summation order; the RG-LRU prefill associates its products in
another order than `jax.lax.associative_scan`), 1e-5 for single layers
and kernels."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models import moe as jmoe
from repro.models import model as jmodel
from repro.models import recurrent as jrec
from repro.models import transformer as jtfm
from repro.models import xlstm as jxlstm

from repro_torch import tree as tree_util
from repro_torch.abft import kernels as kab
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (ModelConfig, get_config, list_archs,
                                 reduce_for_smoke)
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import build_model, moe as tmoe
from repro_torch.models import encdec as tencdec
from repro_torch.models import model as tmodel
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txlstm
from repro_torch.runtime.prefill import BucketedPrefill

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
FAMILIES = {"moe": "phi3.5-moe-42b-a6.6b", "hybrid": "recurrentgemma-2b",
            "vlm": "internvl2-2b", "ssm": "xlstm-125m",
            "audio": "seamless-m4t-medium"}
B, S, STEPS = 2, 16, 4        # hybrid: S % window (8) == 0; ssm: 2 chunks


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _setup(arch):
    jcfg, tcfg = jreduce(jget_config(arch)), reduce_for_smoke(get_config(arch))
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    # non-zero norms and biases, so every parameter shapes the result
    leaves, tdef = jax.tree_util.tree_flatten(jparams)
    r = np.random.RandomState(1)
    leaves = [np.asarray(l) + (0.1 * r.standard_normal(l.shape)).astype(
        np.float32) * (np.asarray(l) == 0) for l in leaves]
    jparams = jax.tree_util.tree_unflatten(tdef, [jnp.asarray(l)
                                                  for l in leaves])
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray,
                                                                jparams))


def _frontend(cfg, seed=5):
    if not cfg.frontend:
        return None
    return (0.1 * np.random.RandomState(seed).standard_normal(
        (B, cfg.frontend_seq, cfg.frontend_dim))).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jcfg, tcfg, jp, tp = _setup(FAMILIES[request.param])
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg, "jp": jp,
            "tp": tp, "fe": _frontend(jcfg)}


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_param_tree_and_counts_match_reference(family):
    jp, tp, tcfg = family["jp"], family["tp"], family["tcfg"]
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in tree_util.flatten_with_path(tp)] == jpaths
    # the port's seeded init builds the same tree with the same shapes
    mine = build_model(tcfg, "cpu").init(seed=0)
    assert [(p, tuple(l.shape)) for p, l in tree_util.flatten_with_path(mine)] \
        == [(p, tuple(l.shape)) for p, l in tree_util.flatten_with_path(tp)]
    n = sum(l.numel() for l in tree_util.leaves(mine))
    assert tmodel.count_params_analytic(tcfg) == n


@pytest.mark.parametrize("arch", list_archs())
def test_full_size_param_counts_match_reference(arch):
    """The formula of every arch the port registers, at full size: the
    reference's config carried field for field into the port's dataclass."""
    cfg = ModelConfig(**dataclasses.asdict(jget_config(arch)))
    assert tmodel.count_params_analytic(cfg) == \
        jmodel.count_params_analytic(jget_config(arch))


@pytest.mark.parametrize("arch", list_archs())
def test_full_size_active_param_counts_match_reference(arch):
    """`active_only` against the reference: a MoE arch counts its router
    and k of its experts, fewer than its total; any other arch its total."""
    cfg = ModelConfig(**dataclasses.asdict(jget_config(arch)))
    active = tmodel.count_params_analytic(cfg, active_only=True)
    assert active == jmodel.count_params_analytic(jget_config(arch),
                                                  active_only=True)
    total = tmodel.count_params_analytic(cfg)
    assert (active < total) if cfg.family == "moe" else (active == total)


@pytest.mark.parametrize("arch", list_archs())
def test_param_count_matches_init(arch):
    """The formula counts what the port's init builds, at smoke size."""
    cfg = reduce_for_smoke(get_config(arch))
    params = build_model(cfg, "cpu").init(seed=0)
    assert tmodel.count_params_analytic(cfg) == \
        sum(l.numel() for l in tree_util.leaves(params))


def test_loss_matches_reference(family):
    jcfg, tcfg, jp, tp, fe = (family[k] for k in
                              ("jcfg", "tcfg", "jp", "tp", "fe"))
    r = np.random.RandomState(3)
    toks = r.randint(0, jcfg.vocab_size, (B, S))
    tgt = r.randint(0, jcfg.vocab_size, (B, S))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "targets": jnp.asarray(tgt, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt)}
    if fe is not None:
        jb["frontend_embeds"], tb["frontend_embeds"] = _j(fe), _t(fe)
    jl, jm = jbuild_model(jcfg).loss(jp, jb)
    tl, tm = build_model(tcfg, "cpu").loss(tp, tb)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), **TOL)
    if family["name"] == "moe":
        # the same tokens drop: the fraction is a count over T * k pairs
        assert float(tm["moe_drop_frac"]) == float(jm["moe_drop_frac"])


def test_prefill_decode_and_cache_match_reference(family):
    """Decode positions count the frontend's embeddings for vlm only: the
    audio family's frames feed the encoder."""
    jcfg, tcfg, jp, tp, fe = (family[k] for k in
                              ("jcfg", "tcfg", "jp", "tp", "fe"))
    P = jcfg.frontend_seq if jcfg.family == "vlm" else 0
    max_len = S + P + STEPS + 4
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size, (B, S))
    if jcfg.family == "audio":
        jl, jc = jencdec.encdec_prefill(jcfg, jp, _j(fe),
                                        jnp.asarray(toks, jnp.int32), max_len,
                                        cache_dtype=jnp.float32)
        tl, tc = tencdec.encdec_prefill(tcfg, tp, _t(fe),
                                        torch.from_numpy(toks), max_len,
                                        cache_dtype=torch.float32)
    else:
        jl, jc = jtfm.lm_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32),
                                 max_len, cache_dtype=jnp.float32,
                                 frontend_embeds=_j(fe))
        tl, tc = ttfm.lm_prefill(tcfg, tp, torch.from_numpy(toks), max_len,
                                 cache_dtype=torch.float32,
                                 frontend_embeds=_t(fe))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)

    def same_cache():
        jpaths = [(jax.tree_util.keystr(p), np.asarray(l)) for p, l in
                  jax.tree_util.tree_flatten_with_path(jc)[0]]
        tpaths = tree_util.flatten_with_path(tc)
        assert [p for p, _ in tpaths] == [p for p, _ in jpaths]
        for (_, t), (_, j) in zip(tpaths, jpaths):
            assert tuple(t.shape) == j.shape
            np.testing.assert_allclose(_np(t), j, **TOL)

    same_cache()
    jmodel_, tmodel_ = jbuild_model(jcfg), build_model(tcfg, "cpu")
    # the all-zero decode cache: the same leaves, shapes, dtypes and values
    jzero = jax.tree_util.tree_flatten_with_path(
        jmodel_.init_cache(B, max_len)[0])[0]
    tzero = tree_util.flatten_with_path(tmodel_.init_cache(B, max_len))
    assert [p for p, _ in tzero] == [jax.tree_util.keystr(p)
                                     for p, _ in jzero]
    for (_, t), (_, j) in zip(tzero, jzero):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
    for i in range(STEPS):
        nxt = np.random.RandomState(10 + i).randint(0, jcfg.vocab_size, (B,))
        jl, jc = jmodel_.decode_step(jp, jc, jnp.asarray(nxt, jnp.int32),
                                     jnp.asarray(S + P + i, jnp.int32))
        tl, tc = tmodel_.decode_step(tp, tc, torch.from_numpy(nxt),
                                     S + P + i)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    same_cache()


@pytest.mark.parametrize("T,bias", [(64, 0.0), (96, 0.05)])
def test_moe_layer_drops_the_same_tokens_as_reference(T, bias):
    """Tokens with a positive mean and a router biased towards expert 0
    overflow its capacity: the same pairs drop, the drop fraction is equal,
    and the output and aux loss match (a dropped pair adds nothing: its
    token keeps the residual path)."""
    jcfg = jreduce(jget_config("phi3.5-moe-42b-a6.6b"))
    tcfg = reduce_for_smoke(get_config("phi3.5-moe-42b-a6.6b"))
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(4), jcfg)
    jp = dict(jp)
    jp["router"] = jp["router"].at[:, 0].add(bias)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = (np.random.RandomState(T).standard_normal((2, T // 2, jcfg.d_model))
         + (1.0 if bias else 0.0)).astype(np.float32)
    jo, jaux = jmoe.moe_mlp(jcfg, jp, jnp.asarray(x))
    to, taux = tmoe.moe_mlp(tcfg, tp, torch.from_numpy(x))
    assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    if bias:
        assert float(taux["moe_drop_frac"]) > 0.1
    np.testing.assert_allclose(_np(to), _np(jo), **LAYER_TOL)
    np.testing.assert_allclose(_np(taux["moe_aux"]), _np(jaux["moe_aux"]),
                               **LAYER_TOL)
    assert tmoe.capacity(tcfg, T) == max(int(np.ceil(2 * T / 4 * 1.25)), 4)


@pytest.mark.parametrize("S_,with_h0", [(1, False), (13, True), (64, False)])
def test_rg_lru_scan_matches_associative_scan(S_, with_h0):
    cfg = jreduce(jget_config("recurrentgemma-2b"))
    tcfg = reduce_for_smoke(get_config("recurrentgemma-2b"))
    jp, _ = jrec.init_recurrent_block(jax.random.PRNGKey(6), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    r = np.random.RandomState(S_)
    u = r.standard_normal((2, S_, cfg.d_rnn)).astype(np.float32)
    h0 = r.standard_normal((2, cfg.d_rnn)).astype(np.float32) \
        if with_h0 else None
    jy, jh = jrec.rg_lru_scan(jp, jnp.asarray(u), _j(h0))
    ty, th = trec.rg_lru_scan(tp, torch.from_numpy(u), _t(h0))
    np.testing.assert_allclose(_np(ty), _np(jy), **LAYER_TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **LAYER_TOL)
    # and the block's decode recurrence, one step from the scan's state
    x = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    conv = r.standard_normal((2, cfg.conv_width - 1, cfg.d_rnn)
                             ).astype(np.float32)
    jo, (jcs, jhs) = jrec.recurrent_block(cfg, jp, jnp.asarray(x),
                                          conv_state=jnp.asarray(conv),
                                          h_state=jh, decode=True)
    to, (tcs, ths) = trec.recurrent_block(tcfg, tp, torch.from_numpy(x),
                                          conv_state=torch.from_numpy(conv),
                                          h_state=th, decode=True)
    for t, j in ((to, jo), (tcs, jcs), (ths, jhs)):
        np.testing.assert_allclose(_np(t), _np(j), **LAYER_TOL)


# (B, H, KV, Sq, Sk, hd, causal, window, block): the families' head dims,
# causal and windowed with Sk > window
WIDE_CASES = [
    (1, 4, 2, 40, 40, 128, True, 0, 16),
    (1, 4, 2, 40, 40, 128, True, 12, 16),
    (1, 2, 1, 48, 48, 256, True, 16, 16),
    (1, 2, 1, 33, 33, 256, True, 0, 16),
    (1, 2, 1, 20, 36, 256, False, 0, 16),
]


@pytest.mark.parametrize("B_,H,KV,Sq,Sk,hd,causal,window,block", WIDE_CASES)
def test_plain_flash_at_wide_head_dims_matches_pallas(B_, H, KV, Sq, Sk, hd,
                                                      causal, window, block):
    r = np.random.RandomState(Sq + hd)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B_, H, Sq, hd), (B_, KV, Sk, hd), (B_, KV, Sk, hd)))
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=block, block_k=block, interpret=True))
    got = kfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("hd", [128, 256])
def test_k2_f32_and_k4_keep_refusing_wide_head_dims(hd):
    """Both bodies take hd 128 and 256 (the f32 body, K2 f32 and K4, since
    its hd 256 keeps one K/V stage); a head dim neither is built for, twice
    the widest, still raises before any launch."""
    kfa.check_head_dim("K2", torch.bfloat16, hd)
    kfa.check_head_dim("K2", torch.float32, hd)
    kfa.check_head_dim("K4", torch.float32, hd)
    with pytest.raises(ValueError, match="built for head_dim"):
        kfa.check_head_dim("K2", torch.float32, 2 * hd + 256)
    with pytest.raises(ValueError, match="K4 .* built for head_dim"):
        kfa.check_head_dim("K4", torch.float32, 2 * hd + 256)
    assert kab.check_head_dim is kfa.check_head_dim


@pytest.mark.parametrize("S_", [5, 11, 16])
def test_windowed_decode_equals_its_own_full_forward(S_):
    """The ring: prefill puts position p at slot p % W, decode writes slot
    pos % W; every decode step's logits equal the full forward's at that
    position, also at S % W != 0 and S < W (where the reference's ring is
    misplaced, ROADMAP Queue 3)."""
    cfg = reduce_for_smoke(get_config("recurrentgemma-2b"))
    W = cfg.window_size
    assert W == 8
    model = build_model(cfg, "cpu")
    params = model.init(seed=0)
    steps = 6
    toks = np.random.RandomState(S_).randint(0, cfg.vocab_size,
                                             (B, S_ + steps))
    full, _, _ = ttfm.lm_hidden(cfg, params, torch.from_numpy(toks))
    want = ttfm.nn.logits_from_hidden(cfg, params["embed"], full)
    logits, cache = ttfm.lm_prefill(cfg, params,
                                    torch.from_numpy(toks[:, :S_]),
                                    S_ + steps + 2, cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(logits), _np(want[:, S_ - 1]), **TOL)
    ring = cache["groups"]["b2_attention"]["k"]
    assert ring.shape[2] == W
    for i in range(steps):
        logits, cache = ttfm.lm_decode_step(
            cfg, params, cache, torch.from_numpy(toks[:, S_ + i]), S_ + i)
        np.testing.assert_allclose(_np(logits), _np(want[:, S_ + i]), **TOL)


@pytest.mark.parametrize("arch,supported", [
    ("qwen2-0.5b", True), ("phi3.5-moe-42b-a6.6b", False),
    ("recurrentgemma-2b", False), ("internvl2-2b", False),
    ("xlstm-125m", False), ("seamless-m4t-medium", False)])
def test_bucketed_prefill_gate_is_the_reference_gate(arch, supported):
    """The reference's gate, but for one deliberate divergence: it admits
    moe, whose pad tokens route through top-k and change the real tokens'
    logits (ROADMAP Queue 3, F2); the port prefills a MoE prompt exactly."""
    model = build_model(reduce_for_smoke(get_config(arch)), "cpu")
    assert BucketedPrefill(model).supported is supported


@pytest.mark.parametrize("field,value,match", [
    ("family", "speech", "unknown model family 'speech'"),
    ("block_pattern", ("mlstm", "mamba"), "unknown block kind 'mamba'")])
def test_unknown_family_or_block_kind_raises(field, value, match):
    """Every family and block kind the reference builds is ported; anything
    else raises, never running as another kind."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("xlstm-125m")),
                              **{field: value})
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match=match):
        ttfm.init_cache(cfg, 1, 8)


def _mlstm_inputs(cfg, S_, seed):
    r = np.random.RandomState(seed)
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = (r.standard_normal((2, H, S_, hd)).astype(np.float32)
               for _ in range(3))
    i_raw = r.standard_normal((2, H, S_)).astype(np.float32)
    f_raw = (3.0 + r.standard_normal((2, H, S_))).astype(np.float32)
    return q, k, v, i_raw, f_raw


@pytest.mark.parametrize("S_,chunk,carried", [(16, 8, False), (8, 8, False),
                                              (24, 8, True), (12, 4, True)])
def test_mlstm_chunkwise_matches_reference_and_sequential(S_, chunk, carried):
    """The chunkwise mLSTM against the JAX `mlstm_chunkwise` and the port's
    token-by-token recurrence, from an empty or a carried (C, n, m)."""
    cfg = reduce_for_smoke(get_config("xlstm-125m"))
    xs = _mlstm_inputs(cfg, S_, S_ + chunk)
    state = None
    if carried:
        warm = _mlstm_inputs(cfg, chunk, 99)
        _, state = jxlstm.mlstm_chunkwise(*map(jnp.asarray, warm), chunk)
        state = tuple(np.array(a) for a in state)
    jh, jst = jxlstm.mlstm_chunkwise(
        *map(jnp.asarray, xs), chunk,
        None if state is None else tuple(map(jnp.asarray, state)))
    tst0 = None if state is None else tuple(map(torch.from_numpy, state))
    th, tst = txlstm.mlstm_chunkwise(*map(torch.from_numpy, xs), chunk, tst0)
    sh, sst = txlstm.ref_mlstm_sequential(*map(torch.from_numpy, xs),
                                          state=tst0)
    for t, j in zip((th, *tst), (jh, *jst)):
        np.testing.assert_allclose(_np(t), _np(j), **LAYER_TOL)
    for t, j in zip((th, *tst), (sh, *sst)):
        np.testing.assert_allclose(_np(t), _np(j), **LAYER_TOL)
    with pytest.raises(ValueError, match="S % chunk"):
        txlstm.mlstm_chunkwise(*map(torch.from_numpy, xs), 5)


@pytest.mark.parametrize("S_,with_state", [(6, False), (1, True)])
def test_slstm_block_matches_reference(S_, with_state):
    """One sLSTM block (conv, gates, the token loop, head norm and gated
    FFN) and its state, from an empty state or (S = 1, a decode step) from
    a carried one."""
    jcfg = jreduce(jget_config("xlstm-125m"))
    tcfg = reduce_for_smoke(get_config("xlstm-125m"))
    jp, _ = jxlstm.init_slstm_block(jax.random.PRNGKey(8), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    r = np.random.RandomState(S_)
    D = jcfg.d_model
    x = r.standard_normal((2, S_, D)).astype(np.float32)
    state = None
    if with_state:
        conv = r.standard_normal((2, jcfg.conv_width - 1, D))
        cell = [r.standard_normal((2, D)) for _ in range(4)]
        cell[1] = np.abs(cell[1]) + 0.5          # a positive normalizer
        state = (conv.astype(np.float32),
                 tuple(c.astype(np.float32) for c in cell))
    jo, (jcs, jcell) = jxlstm.slstm_block(
        jcfg, jp, jnp.asarray(x), decode=with_state,
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    to, (tcs, tcell) = txlstm.slstm_block(
        tcfg, tp, torch.from_numpy(x), decode=with_state,
        state=None if state is None else (torch.from_numpy(state[0]),
                                          tuple(map(torch.from_numpy,
                                                    state[1]))))
    for t, j in zip((to, tcs, *tcell), (jo, jcs, *jcell)):
        np.testing.assert_allclose(_np(t), _np(j), **LAYER_TOL)


def test_encoder_layer_matches_reference():
    """One bidirectional encoder layer (and the final norm) over the stub
    frames."""
    jcfg = dataclasses.replace(jreduce(jget_config("seamless-m4t-medium")),
                               encoder_layers=1)
    tcfg = dataclasses.replace(
        reduce_for_smoke(get_config("seamless-m4t-medium")), encoder_layers=1)
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(9))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    frames = np.random.RandomState(9).standard_normal(
        (2, 11, jcfg.d_model)).astype(np.float32)
    want = jencdec.encode(jcfg, jp, jnp.asarray(frames))
    got = tencdec.encode(tcfg, tp, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
