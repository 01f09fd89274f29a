"""LM training on the port (`repro_torch.models.lm.make_train_step`, AdamW
with its warm-up-cosine schedule, `save_trainer_state` /
`restore_trainer_state`, `python -m repro_torch.launch.train`) against the
reference, from the same carried parameters (`interop.lm_params_from_numpy`)
and the same batches.

On the CPU, at `reduced()` in float32, for gemma3-4b (sliding-window and
global attention, GQA, QK-norm), h2o-danube-3-4b, rwkv6-3b (the wkv
recurrence), jamba-1.5-large-398b (the Mamba scan through `SelectiveScanFn`
and its plain backward, MoE with its aux loss),
llama4-maverick-400b-a17b (top-1 MoE with a shared expert), grok-1-314b
(top-2 MoE) and whisper-large-v3 (the encoder and the decoder's
cross-attention, frame embeddings in the batch), against the reference's
`jax.value_and_grad` step:
  * the loss at rtol 1e-5 (the forward's tolerance in tests/test_torch_lm.py);
  * every gradient leaf within 1e-4 max(1, max |g_ref|) (float32 sums in
    another order through the whole backward);
  * the losses of the next two of 3 AdamW + warm-up-cosine steps at rtol
    1e-4 (the parameters' small differences carried through the updates).
`remat=True` against `remat=False` (torch.utils.checkpoint per period;
jamba's period runs the selective scan's Function forward again, whisper's
takes the encoder's output through the checkpoint):
equal, bit for bit.  A checkpoint saved mid-training and restored continues
to the uninterrupted run's losses, bit for bit (bf16 parameters).  The
launcher, called in-process through `main(argv)`: the loss goes down and
`--ckpt` writes a checkpoint that restores."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as jopt  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.checkpoint import restore_trainer_state, save_trainer_state  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

TRAINED = ["gemma3-4b", "h2o-danube-3-4b", "rwkv6-3b", "jamba-1.5-large-398b",
           "llama4-maverick-400b-a17b", "grok-1-314b", "whisper-large-v3"]
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAJECTORY_RTOL = 1e-4
B, S = 2, 16


def _pair(name, **overrides):
    """(reference config, port config, reference params, carried params)."""
    jc, tc = JARCHS[name].reduced(**overrides), ARCHS[name].reduced(**overrides)
    jp = jt.init_params(jc, jax.random.PRNGKey(2))
    return jc, tc, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed):
    """Tokens, labels and, for an encoder-decoder configuration, float32
    frame embeddings (B, n_frames, d_model) (else None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    frames = None if cfg.encoder is None else rng.standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], frames


def _batches(x, y, frames):
    jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    tb = {"tokens": torch.from_numpy(x).long(), "labels": torch.from_numpy(y).long()}
    if frames is not None:
        jb["enc_embeds"], tb["enc_embeds"] = jnp.asarray(frames), torch.from_numpy(frames)
    return jb, tb


def _grad_recorder():
    """An optimizer whose update returns the gradients as its state."""
    return topt.Optimizer(init=lambda p: None, update=lambda p, g, s: (p, g))


def _recording(opt, zeros_like):
    """``opt`` with the last step's gradients kept beside its state, so one
    (jitted) step gives the loss, the update and the gradients."""
    def update(p, g, s):
        p, inner = opt.update(p, g, s[0])
        return p, (inner, g)
    return opt._replace(init=lambda p: (opt.init(p), zeros_like(p)), update=update)


def _schedule_adamw(m):
    return m.adamw(m.warmup_cosine_schedule(3e-3, 2, 3))


@pytest.mark.parametrize("name", TRAINED)
def test_train_step_matches_reference(name):
    """Step 1's loss and every gradient leaf, then the losses of steps 2
    and 3, all under AdamW with the launcher's warm-up-cosine schedule."""
    jc, tc, jp, tp = _pair(name)
    jopt_ = _recording(_schedule_adamw(jopt), lambda p: jax.tree.map(jnp.zeros_like, p))
    topt_ = _recording(_schedule_adamw(topt), lambda p: None)
    jstep = jax.jit(jlm.make_train_step(jc, jopt_))
    tstep = tlm.make_train_step(tc, topt_)
    js, ts = jopt_.init(jp), topt_.init(tp)
    for i in range(3):
        jb, tb = _batches(*_batch(jc, 10 + i))
        jloss, jp, js = jstep(jp, js, jb)
        loss, tp, ts = tstep(tp, ts, tb)
        if i == 0:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
            got, want = tree_leaves(ts[1]), jax.tree.leaves(js[1])
            assert [tuple(g.shape) for g in got] == [w.shape for w in want]
            for j, (g, w) in enumerate(zip(got, want)):
                w = np.asarray(w, np.float64)
                err = float(np.abs(g.numpy().astype(np.float64) - w).max())
                assert err <= GRAD_RTOL * max(1.0, float(np.abs(w).max())), (j, err)
        else:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=TRAJECTORY_RTOL)
    assert ts[0]["step"] == 3


@pytest.mark.parametrize("name,n_layers", [("gemma3-4b", 6), ("h2o-danube-3-4b", 2),
                                           ("rwkv6-3b", 3), ("jamba-1.5-large-398b", 8),
                                           ("whisper-large-v3", 3)])
def test_remat_gives_the_same_gradients_bit_for_bit(name, n_layers):
    cfg = ARCHS[name].reduced(n_layers=n_layers)
    params = tt.init_params(cfg, seed=1, device="cpu")
    _, tb = _batches(*_batch(cfg, 3))
    results = [tlm.make_train_step(dataclasses.replace(cfg, remat=remat), _grad_recorder())(
        params, None, tb) for remat in (False, True)]
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(tree_leaves(results[0][2]), tree_leaves(results[1][2])):
        assert torch.equal(a, b)


def test_trainer_checkpoint_restores_and_continues(tmp_path):
    cfg = ARCHS["h2o-danube-3-4b"].reduced(param_dtype="bfloat16")
    opt = topt.adamw(topt.warmup_cosine_schedule(3e-3, 2, 4))
    step = tlm.make_train_step(cfg, opt)
    batches = [_batches(*_batch(cfg, 20 + i))[1] for i in range(4)]

    params = tt.init_params(cfg, seed=4, device="cpu")
    state = opt.init(params)
    straight = []
    for b in batches:
        loss, params, state = step(params, state, b)
        straight.append(float(loss))

    params = tt.init_params(cfg, seed=4, device="cpu")
    state = opt.init(params)
    resumed = []
    for b in batches[:2]:
        loss, params, state = step(params, state, b)
        resumed.append(float(loss))
    path = str(tmp_path / "trainer.ckpt")
    save_trainer_state(path, params, state, 2, {"arch": cfg.name})
    p2, s2, round_idx, extra = restore_trainer_state(path, device="cpu")
    assert (round_idx, extra, s2["step"]) == (2, {"arch": cfg.name}, 2)
    for a, b in zip(tree_leaves(p2), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for b in batches[2:]:
        loss, p2, s2 = step(p2, s2, b)
        resumed.append(float(loss))
    assert resumed == straight


def test_launcher_trains_rwkv6_reduced_and_writes_a_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "lm.ckpt")
    out = tlaunch.main(["--arch", "rwkv6-3b", "--reduced", "--steps", "20",
                        "--device", "cpu", "--ckpt", path])
    printed = capsys.readouterr().out
    assert "step    0  loss" in printed and f"checkpoint -> {path}" in printed
    assert len(out["losses"]) == 20 and out["last_loss"] < out["first_loss"]
    params, state, round_idx, extra = restore_trainer_state(path, device="cpu")
    assert (round_idx, extra, state["step"]) == (20, {"arch": "rwkv6-3b"}, 20)
    cfg = ARCHS["rwkv6-3b"].reduced(vocab_size=512)
    shapes = [tuple(t.shape) for t in tree_leaves(tt.init_params(cfg, device="cpu"))]
    assert [tuple(t.shape) for t in tree_leaves(params)] == shapes
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))


def test_launcher_refuses_a_non_token_frontend():
    with pytest.raises(SystemExit, match="token"):
        tlaunch.main(["--arch", "whisper-large-v3", "--reduced", "--steps", "1",
                      "--device", "cpu"])
