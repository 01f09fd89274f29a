"""The port's LM zoo inference path (`repro_torch.models.{transformer,
decode,lm}`, `repro_torch.configs`, `repro_torch.data.lm`) against the
reference, with the reference's parameters carried across
(`interop.lm_params_from_numpy`, bit for bit).

On the CPU, at `reduced()` in float32: `forward` logits within 1e-4 of the
largest logit and `lm_loss` within 1e-5 relative, for gemma3-4b, gemma-7b,
h2o-danube-3-4b, minitron-8b and rwkv6-3b (the two orders of float32 sums
differ in the last bits), for jamba-1.5-large-398b (Mamba, MoE),
llama4-maverick-400b-a17b (MoE with a shared expert) and grok-1-314b
(MoE), and for whisper-large-v3 with frame embeddings (its encoder at
head_dim 128, the decoder's cross-attention over 16 frames); gemma3 also at
S = 2048 (the reference's `attend_chunked`) and at n_layers = 8 (remainder
layers), whisper also without frames (no cross-attention, as in the
reference).  In bfloat16 the two frameworks round at other places: logits
within 3e-2 of the largest and the loss within 1e-3 relative, whisper
also with float32 frames into bf16 weights (jnp's promotion: the encoder
and the cross K/V in float32); the embedding scale is bit for bit (the
scalar rounds to bf16 first).  `transformer.encode` and `warm_cache`'s
cross K/V against the reference's within 1e-4 of their largest.
`decode_step` against `forward` at the reference's contract (2e-2
relative, ring buffers wrapping 3x), the Mamba, MoE and whisper
configurations included; `greedy_generate` per-step logits within 1e-4 and
tokens equal wherever the top-2 margin exceeds that.  `ARCHS` equal the
reference's field by field; `param_shapes` of every full config equal
`param_specs`; every configuration runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import LONG_CONTEXT_OK as JLONG  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.data import lm as jdata  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import ARCHS, LONG_CONTEXT_OK, SHAPES, shape_applicable  # noqa: E402
from repro_torch.data import lm as tdata  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as twkv  # noqa: E402
from repro_torch.models import decode as tdecode  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

RUNNABLE = ["gemma3-4b", "gemma-7b", "h2o-danube-3-4b", "minitron-8b", "rwkv6-3b",
            "jamba-1.5-large-398b", "llama4-maverick-400b-a17b", "grok-1-314b",
            "whisper-large-v3"]
LOGIT_RTOL_F32 = 1e-4       # of the largest |logit|
LOSS_RTOL_F32 = 1e-5
LOGIT_RTOL_BF16 = 3e-2
LOSS_RTOL_BF16 = 1e-3
DECODE_RTOL = 2e-2          # tests/test_decode_parity.py


def _pair(name, **overrides):
    """(reference config, port config, reference params, carried params)."""
    jc, tc = JARCHS[name].reduced(**overrides), ARCHS[name].reduced(**overrides)
    jp = jt.init_params(jc, jax.random.PRNGKey(1))
    return jc, tc, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)
                                                ).astype(np.int32)


def _frames(cfg, B, seed, dtype=None):
    """Frame embeddings (B, n_frames, d_model) for an encoder-decoder
    configuration, drawn in float32 and given as a (jnp, torch) pair in
    ``dtype`` (default: the weights'); (None, None) for the others."""
    if cfg.encoder is None:
        return None, None
    x = np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    dtype = dtype or cfg.param_dtype
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _compare_forward(name, B, S, logit_rtol, loss_rtol, frames=True, frame_dtype=None,
                     **overrides):
    """Logits and loss of the port against the reference's, the frame
    embeddings (``frame_dtype``, default the weights') passed to an
    encoder-decoder configuration unless ``frames`` is False."""
    jc, tc, jp, tp = _pair(name, **overrides)
    toks, labels = _tokens(jc, B, S, 0), _tokens(jc, B, S, 1)
    jf, tf = _frames(jc, B, 5, frame_dtype) if frames else (None, None)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long()}
    if jf is not None:
        jbatch["enc_embeds"], tbatch["enc_embeds"] = jf, tf
    jlogits, _, _ = jax.jit(lambda p: jt.forward(
        jc, p, tokens=jbatch["tokens"], enc_embeds=jbatch.get("enc_embeds")))(jp)
    jloss = float(jax.jit(lambda p: jlm.lm_loss(jc, p, jbatch))(jp))
    with torch.inference_mode():
        tlogits, _, _ = tt.forward(tc, tp, tokens=tbatch["tokens"],
                                   enc_embeds=tbatch.get("enc_embeds"))
    tloss = float(tlm.make_eval_step(tc)(tp, tbatch))
    want = np.asarray(jlogits, np.float32)
    got = tlogits.float().numpy()
    assert got.shape == want.shape == (B, S, jc.padded_vocab)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= logit_rtol, f"{name}: logits rel err {err}"
    assert abs(tloss - jloss) <= loss_rtol * abs(jloss), (tloss, jloss)


@pytest.mark.parametrize("name", RUNNABLE)
def test_forward_and_loss_match_reference(name):
    _compare_forward(name, 2, 40, LOGIT_RTOL_F32, LOSS_RTOL_F32)


@pytest.mark.parametrize("case", ["chunked-S2048", "remainder-layers", "bf16",
                                  "rwkv-bf16", "whisper-bf16",
                                  "whisper-bf16-float32-frames", "whisper-no-frames"])
def test_forward_variants_match_reference(case):
    if case == "chunked-S2048":      # S >= 2048 takes attend_chunked in both
        _compare_forward("gemma3-4b", 1, 2048, LOGIT_RTOL_F32, LOSS_RTOL_F32)
    elif case == "remainder-layers":  # 8 = one period of 6 + 2 remainder layers
        _compare_forward("gemma3-4b", 2, 40, LOGIT_RTOL_F32, LOSS_RTOL_F32, n_layers=8)
    elif case == "bf16":             # d_model 160: sqrt(160) is not a bf16 value
        _compare_forward("gemma3-4b", 2, 40, LOGIT_RTOL_BF16, LOSS_RTOL_BF16,
                         param_dtype="bfloat16", d_model=160)
    elif case == "rwkv-bf16":
        _compare_forward("rwkv6-3b", 2, 40, LOGIT_RTOL_BF16, LOSS_RTOL_BF16,
                         param_dtype="bfloat16")
    elif case == "whisper-bf16":
        _compare_forward("whisper-large-v3", 2, 40, LOGIT_RTOL_BF16, LOSS_RTOL_BF16,
                         param_dtype="bfloat16")
    elif case == "whisper-bf16-float32-frames":
        # jnp promotes: the encoder and the cross K/V run in float32
        _compare_forward("whisper-large-v3", 2, 40, LOGIT_RTOL_BF16, LOSS_RTOL_BF16,
                         frame_dtype="float32", param_dtype="bfloat16")
    else:                            # the decoder alone: cross-attention skipped
        _compare_forward("whisper-large-v3", 2, 40, LOGIT_RTOL_F32, LOSS_RTOL_F32,
                         frames=False)


@pytest.mark.parametrize("d_model", [2560, 160, 256])
def test_embedding_scale_bit_exact_in_bf16(d_model):
    """`h * jnp.asarray(d_model ** 0.5, bf16)`: the scalar is rounded to bf16
    before the product (sqrt(2560) = 50.596 -> 50.5)."""
    cfg = dataclasses.replace(ARCHS["gemma3-4b"], d_model=d_model, vocab_size=64,
                              vocab_pad_multiple=1)
    rng = np.random.default_rng(d_model)
    table = jnp.asarray(rng.standard_normal((64, d_model)).astype(np.float32)
                        ).astype(jnp.bfloat16)
    toks = rng.integers(0, 64, size=(2, 5))
    want = table[jnp.asarray(toks)] * jnp.asarray(d_model ** 0.5, jnp.bfloat16)
    params = lm_params_from_numpy({"embed": np.asarray(table)}, "cpu")
    got = tt.embed_tokens(cfg, params, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("name", ["gemma3-4b", "rwkv6-3b", "h2o-danube-3-4b",
                                  "jamba-1.5-large-398b", "grok-1-314b",
                                  "llama4-maverick-400b-a17b", "whisper-large-v3"])
def test_decode_matches_forward(name):
    """The reference's contract: decode over S tokens == forward (windows of
    8 at S = 24, so the ring buffers wrap 3x; whisper's steps read the cross
    K/V that `warm_cache` filled from the same frames)."""
    _, tc, _, tp = _pair(name)
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(tc, B, S, 2)).long()
    frames = _frames(tc, B, 5)[1]
    with torch.inference_mode():
        ref, _, _ = tt.forward(tc, tp, tokens=toks, enc_embeds=frames)
        cache = tdecode.warm_cache(tc, tp, tdecode.init_cache(tc, B, S, device="cpu"),
                                   enc_embeds=frames)
        outs = []
        for i in range(S):
            logits, cache = tdecode.decode_step(tc, tp, cache, toks[:, i:i + 1])
            outs.append(logits)
    dec = torch.cat(outs, dim=1)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < DECODE_RTOL, f"{name}: rel err {rel}"
    assert cache["pos"] == S


@pytest.mark.parametrize("name", ["gemma3-4b", "rwkv6-3b"])
def test_greedy_generate_matches_reference(name):
    jc, tc, jp, tp = _pair(name)
    prompt = _tokens(jc, 2, 5, 3)
    max_new, seq_len = 6, 16
    jtoks = np.asarray(jlm.greedy_generate(jc, jp, jnp.asarray(prompt), max_new, seq_len))
    ttoks = tlm.greedy_generate(tc, tp, torch.from_numpy(prompt).long(), max_new,
                                seq_len).numpy()
    assert ttoks.shape == jtoks.shape == (2, 5 + max_new)
    np.testing.assert_array_equal(ttoks[:, :5], prompt)
    # per-step logits on the reference's tokens: within tolerance, and the
    # tokens equal wherever the top-2 margin exceeds it
    jstep = jax.jit(lambda p, c, t: jdecode.decode_step(jc, p, c, t))
    jcache = jdecode.init_cache(jc, 2, seq_len)
    tcache = tdecode.init_cache(tc, 2, seq_len, device="cpu")
    serve = tlm.make_serve_step(tc)
    for i in range(jtoks.shape[1] - 1):
        tok = jtoks[:, i:i + 1]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok))
        tl, tcache = serve(tp, tcache, torch.from_numpy(tok.copy()).long())
        jl, tl = np.asarray(jl)[:, -1], tl[:, -1].numpy()
        tol = LOGIT_RTOL_F32 * np.abs(jl).max()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        if i + 1 >= 5:
            assert (ttoks[clear, i + 1] == jtoks[clear, i + 1]).all()


def test_archs_equal_reference_field_by_field():
    assert list(ARCHS) == list(JARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JARCHS[name]), name
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            JARCHS[name].reduced()), name
        for shape in SHAPES:
            assert shape_applicable(name, shape)[0] == (shape != "long_500k"
                                                        or JLONG[name])
    assert LONG_CONTEXT_OK == JLONG
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


def _jax_shapes(tree):
    if isinstance(tree, dict):
        return {k: _jax_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_shapes(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype)


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_param_shapes_equal_reference_specs(name):
    """Every full configuration, without allocating (meta tensors on the
    port's side, eval_shape on the reference's)."""
    want = _jax_shapes(jt.param_specs(JARCHS[name]))
    got = tt.param_shapes(ARCHS[name])

    def named(tree):
        if isinstance(tree, dict):
            return {k: named(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [named(v) for v in tree]
        return tree[0], str(tree[1]).replace("torch.", "")
    assert named(got) == want


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_configuration_runs(name):
    """Nothing refuses a configuration of `configs/`: at `reduced()`, from
    `init_params`, the forward (with frames where there is an encoder) and
    two decode steps after `warm_cache` give finite logits."""
    cfg = ARCHS[name].reduced()
    params = tt.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, 6, 4)).long()
    frames = _frames(cfg, 1, 6)[1]
    with torch.inference_mode():
        logits, _, _ = tt.forward(cfg, params, tokens=toks, enc_embeds=frames)
        cache = tdecode.warm_cache(cfg, params, tdecode.init_cache(cfg, 1, 6, device="cpu"),
                                   enc_embeds=frames)
        for i in range(2):
            step, cache = tdecode.decode_step(cfg, params, cache, toks[:, i:i + 1])
            assert torch.isfinite(step[..., :cfg.vocab_size]).all()
    assert logits.shape == (1, 6, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()


ENCODER_CASES = {"float32": ("float32", "float32"),
                 "bf16-weights-float32-frames": ("bfloat16", "float32")}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encode_matches_reference(case):
    """whisper's encoder over the same frames, within 1e-4 of its largest
    output; float32 frames into bf16 weights run in float32 in both."""
    param_dtype, frame_dtype = ENCODER_CASES[case]
    jc, tc, jp, tp = _pair("whisper-large-v3", param_dtype=param_dtype)
    jf, tf = _frames(jc, 2, 7, frame_dtype)
    want = np.asarray(jax.jit(lambda p: jt.encode(jc, p, jf))(jp))
    with torch.inference_mode():
        got = tt.encode(tc, tp, tf)
    assert got.shape == want.shape == (2, jc.encoder.n_frames, jc.d_model)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype) == frame_dtype
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= LOGIT_RTOL_F32, f"encoder output rel err {err}"


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_warm_cache_matches_reference(case):
    """Each cross-attention layer's kc / vc after `warm_cache`, against the
    reference's, within 1e-4 of their largest; written into the cache's own
    tensors where their dtype fits, a float32 entry for float32 frames into
    bf16 weights (the reference's promoted arrays)."""
    param_dtype, frame_dtype = ENCODER_CASES[case]
    jc, tc, jp, tp = _pair("whisper-large-v3", param_dtype=param_dtype, n_layers=3)
    jf, tf = _frames(jc, 2, 8, frame_dtype)
    jcache = jdecode.warm_cache(jc, jp, jdecode.init_cache(jc, 2, 8), enc_embeds=jf, pos=3)
    tcache = tdecode.init_cache(tc, 2, 8, device="cpu")
    before = tcache["layers"][0]["kc"]
    with torch.inference_mode():
        got = tdecode.warm_cache(tc, tp, tcache, enc_embeds=tf, pos=3)
    assert got["pos"] == 3 and tc.n_periods == 3
    for name in ("kc", "vc"):
        want = np.asarray(jcache["layers"][0][name])
        t = got["layers"][0][name]
        assert t.shape == want.shape == (3, 2, jc.encoder.n_frames, jc.n_kv_heads,
                                         jc.head_dim)
        assert str(t.dtype).removeprefix("torch.") == str(want.dtype) == frame_dtype
        err = np.abs(t.numpy() - want).max() / np.abs(want).max()
        assert err <= LOGIT_RTOL_F32, f"{name} rel err {err}"
    assert (got["layers"][0]["kc"] is before) == (param_dtype == frame_dtype)


def test_lm_params_carry_across_bit_for_bit_in_bf16():
    jc = JARCHS["gemma3-4b"].reduced(param_dtype="bfloat16", n_layers=8)
    jp = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.PRNGKey(7)))
    tp = lm_params_from_numpy(jp, "cpu")
    assert isinstance(tp["layers"], list) and len(tp["rem_layers"]) == 2
    want, got = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(want) == len(got) > 20
    n_bf16 = 0
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        if w.dtype.name == "bfloat16":
            n_bf16 += 1
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    assert n_bf16 > 20


def test_lm_params_carry_the_encoder_bit_for_bit():
    """whisper's tree: `params["encoder"]` (a list of layer dicts and its
    final LayerNorm) and the decoder's cross-attention weights cross in
    the reference's leaf order, bf16 bit for bit."""
    jc = JARCHS["whisper-large-v3"].reduced(param_dtype="bfloat16", n_layers=2)
    jp = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.PRNGKey(9)))
    tp = lm_params_from_numpy(jp, "cpu")
    assert isinstance(tp["encoder"]["layers"], list) and len(tp["encoder"]["layers"]) == 2
    assert set(tp["encoder"]["final_norm"]) == {"scale", "bias"}
    assert {"qc", "kc", "vc", "oc", "norm_c"} <= set(tp["layers"][0])
    want, got = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))


def test_init_params_tree_matches_param_shapes():
    cfg = ARCHS["gemma3-4b"].reduced(n_layers=7)
    params = tt.init_params(cfg, seed=3, device="cpu")
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape), tree.dtype
    assert shapes(params) == tt.param_shapes(cfg)
    again = tt.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))


def test_cpu_tensors_launch_no_kernel():
    cfg = ARCHS["rwkv6-3b"].reduced()
    params = tt.init_params(cfg, seed=0, device="cpu")
    f0, w0 = tfa.launches, twkv.launches
    toks = torch.zeros((1, 6), dtype=torch.long)
    loss = tlm.make_eval_step(cfg)(params, {"tokens": toks, "labels": toks})
    assert torch.isfinite(loss) and (tfa.launches, twkv.launches) == (f0, w0)


def test_token_stream_and_batches_equal_reference():
    a = tdata.make_token_stream(97, 500, seed=4)
    np.testing.assert_array_equal(a, jdata.make_token_stream(97, 500, seed=4))
    for (x, y), (jx, jy) in zip(tdata.batch_stream(a, 3, 16, 4, seed=1),
                                jdata.batch_stream(a, 3, 16, 4, seed=1)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
