"""The port's Stage-1 text distillation (SAM3-LiteText) against the JAX
package's, in fp32 on the CPU: one ``stage1_text_train_step`` of each on
the same variables and batch, for MobileCLIP-S0 (the 'mct' tower, whose
BatchNorm statistics update after each of the step's two passes) at
context 16 and for a tiny causal 'base' tower (dim 32, 2 layers). JAX's
step runs optax's chain(clip_by_global_norm(5), adamw(1e-3, weight_decay
0.05)); the port's step its ``make_text_optimizer``. Loss parts, gradients,
BatchNorm statistics and, given JAX's gradients, the optimizer's update
are held to JAX's; ``permute_words`` against JAX's on the same numpy
generator.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientsam3_tpu.models import mobile_clip as jmc
from efficientsam3_tpu.train import stage1_text as jst
from efficientsam3_tpu_torch.models import mobile_clip as pmc
from efficientsam3_tpu_torch.train import stage1_text as pst
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables
from test_torch_train_slice import random_variables

CTX, B = 16, 3
TINY = dict(dim=32, layers=2, heads=2, variant="base", causal=True)


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, CTX), np.int32)
    perm = np.zeros((B, CTX), np.int32)
    for i in range(B):
        n = 4 + 2 * i
        words = rng.integers(320, 49000, n - 2)
        tokens[i, :n] = [49406, *words, 49407]
        perm[i, :n] = [49406, *rng.permutation(words), 49407]
    f = lambda: rng.standard_normal((B, CTX, 256)).astype(np.float32)  # noqa: E731
    return {"tokens": tokens, "tokens_perm": perm, "teacher": f(), "teacher_perm": f()}


@pytest.fixture(scope="module", params=["MobileCLIP-S0", "tiny-causal"])
def steps(request):
    """(JAX: variables, grads, new variables, metrics; port: model before
    the step as a state_dict, model after, metrics, gradients)."""
    name = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jmc.MOBILECLIP_TEXT_CFGS, name, jmc.MOBILECLIP_TEXT_CFGS.get(name, TINY))
        mp.setitem(pmc.MOBILECLIP_TEXT_CFGS, name, pmc.MOBILECLIP_TEXT_CFGS.get(name, TINY))
        jcfg = jst.Stage1TextConfig(backbone_type=name, context_length=CTX)
        jm = jst.make_text_student(jcfg)
        nb = make_batch()
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(nb["tokens"]))
        variables = random_variables(shapes, seed=4)
        tx = optax.chain(optax.clip_by_global_norm(jcfg.grad_clip),
                         optax.adamw(jcfg.base_lr, weight_decay=jcfg.weight_decay))

        def tap_update(grads, state, params):  # hands the gradients out with the state
            updates, state = tx.update(grads, state, params)
            return updates, (state, grads)

        tap = optax.GradientTransformation(tx.init, tap_update)
        jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
        new_vars, (_, grads), metrics = jax.jit(
            lambda v, o, bt: jst.stage1_text_train_step(jm, tap, jcfg, v, o, bt))(
                variables, tx.init(variables["params"]), jbatch)

        cfg = pst.Stage1TextConfig(backbone_type=name, context_length=CTX)
        pm = load_jax_variables(pst.make_text_student(cfg), variables)
        fresh = load_jax_variables(pst.make_text_student(cfg), variables)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    opt = pst.make_text_optimizer(cfg, pm)
    captured = {}
    clip_and_update = opt.step

    def step():  # keep the gradients before the in-place clip (unused: JAX's 0)
        captured.update({k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                         for k, p in pm.named_parameters()})
        clip_and_update()

    opt.step = step
    tbatch = {k: torch.from_numpy(v).long() if k.startswith("tokens") else torch.from_numpy(v)
              for k, v in nb.items()}
    got = pst.stage1_text_train_step(pm, opt, cfg, tbatch)
    return dict(name=name, cfg=cfg, variables=variables, grads=grads, new=new_vars,
                metrics={k: float(v) for k, v in metrics.items()}, before=before, model=pm,
                got={k: float(v) for k, v in got.items()}, port_grads=captured, fresh=fresh)


def test_loss_parts_match_jax(steps):
    """loss, mse, cosine and perm within 1e-5 relative (fp32 both sides)."""
    want, got = steps["metrics"], steps["got"]
    assert sorted(got) == sorted(want) == ["cosine", "loss", "mse", "perm"]
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-5 * max(1.0, abs(w)), (k, got[k], w)


def test_gradients_and_statistics_match_jax(steps):
    """Every parameter's gradient (before clipping): ||port - jax|| <= 1e-4
    ||jax|| + 1e-6 of the norm of all of them (the second term for the
    BatchNorm biases, whose exact gradient is 0 under batch statistics);
    the 'mct' tower's BatchNorm statistics after the two passes within
    1e-5 relative."""
    want = convert_variables({"params": steps["grads"]})
    got = steps["port_grads"]
    assert got.keys() == want.keys()
    total = np.sqrt(sum(np.square(v, dtype=np.float64).sum() for v in want.values()))
    for k, w in want.items():
        assert np.linalg.norm(got[k].numpy() - w) <= 1e-4 * np.linalg.norm(w) + 1e-6 * total, k
    stats = convert_variables({"batch_stats": steps["new"].get("batch_stats", {})})
    assert bool(stats) == (steps["name"] == "MobileCLIP-S0")
    sd = steps["model"].state_dict()
    for k, w in stats.items():
        assert not np.allclose(w, steps["before"][k].numpy()), k
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_optimizer_update_matches_jax(steps):
    """Fed JAX's gradients, the port's clip + AdamW gives JAX's updated
    parameters within two fp32 ulps of the parameter plus 1e-3 of the
    learning rate; every parameter moved in the port's own step."""
    cfg, fresh = steps["cfg"], steps["fresh"]
    opt = pst.make_text_optimizer(cfg, fresh)
    jgrads = convert_variables({"params": steps["grads"]})
    for k, p in fresh.named_parameters():
        p.grad = torch.tensor(jgrads[k])
    opt.step()
    new = convert_variables({"params": steps["new"]["params"]})
    for k, p in fresh.named_parameters():
        tol = 2 * np.spacing(np.abs(new[k]).astype(np.float32)) + 1e-3 * cfg.base_lr
        assert (np.abs(p.detach().numpy() - new[k]) <= tol).all(), k
    sd = steps["model"].state_dict()
    for k, p in steps["model"].named_parameters():
        assert not torch.equal(sd[k], steps["before"][k]), k


def test_permute_words_matches_jax():
    for text in ("a red ball on the grass", "dog", "two cats"):
        a = jst.permute_words(text, np.random.default_rng(5))
        b = pst.permute_words(text, np.random.default_rng(5))
        assert a == b and sorted(a.split()) == sorted(text.split())
