"""The port's overfit-to-quality scripts against the JAX package on the
CPU, at the tiny config (EfficientViT b0, embed 8, 112², MobileCLIP-S0 at
context 16; one fusion and one decoder layer, dropout off on both sides):

  - train_overfit_quality: the fixture batch (images, targets and token
    ids, both tokenizers reading the synthetic byte-level BPE file) equals
    the JAX script's; the port's detector loop, 3 steps from the JAX
    weights carried over by ``utils/convert.py``, against JAX's
    ``stage3_train_step`` under the JAX script's optimizer config, scanned
    as the JAX script scans it: loss and every part of each step within
    1e-4 relative, grad_norm within 1e-3 (2e-4 to 4e-4 seen: ReLU and
    hardswish inputs within rounding of 0 fall on either side in another
    summation order, as tests/test_torch_train_slice.py sets out);
  - eval_quality: the harness oracle's metrics (perfect and degraded)
    against the JAX script's, within 1e-9.
"""

import importlib.util

import numpy as np
import pytest

import _torch_threads  # noqa: F401

import flax.linen as nn
import jax
import jax.numpy as jnp

from test_torch_train_slice import CTX, random_variables

from efficientsam3_tpu.build import make_student_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.scripts import _common
from efficientsam3_tpu_torch.scripts import eval_quality as port_eval
from efficientsam3_tpu_torch.scripts import train_overfit_quality as port_train
from efficientsam3_tpu_torch.utils.convert import load_jax_variables

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
FIXTURE = dict(num_images=1, size=112, seed=3, r_lo=10, r_hi=22)
RES, STEPS, LR, PRESENCE = 112, 3, 2e-4, 60.0


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "bytes.txt.gz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EFFICIENTSAM3_BPE_PATH", _common.write_byte_level_bpe(path))
        yield path


@pytest.fixture(scope="module")
def batches(bpe):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EFFICIENTSAM3_BPE_PATH", bpe)
        jmod = jax_script("train_overfit_quality")
        mp.setattr(jmod, "FIXTURE", FIXTURE)
        mp.setattr(port_train, "FIXTURE", FIXTURE)
        jbatch = jmod.build_fixture_batch(CTX, RES)[0]
        pbatch = port_train.build_fixture_batch(CTX, RES)[0]
    return jbatch, pbatch


def test_fixture_batch_and_tokens_match_jax(batches):
    jbatch, pbatch = batches
    tokens = pbatch["tokens"].numpy()
    np.testing.assert_array_equal(tokens, np.asarray(jbatch["tokens"]))
    assert tokens[0, 0] == 512 and (tokens == 513).sum() == len(tokens)  # byte-level ids
    np.testing.assert_array_equal(pbatch["images"].numpy(), np.asarray(jbatch["images"]))
    for k in ("boxes", "valid", "masks", "is_exhaustive"):
        np.testing.assert_array_equal(pbatch["targets"][k].numpy(),
                                      np.asarray(jbatch["targets"][k]))


@pytest.fixture(scope="module")
def runs(batches):
    """(JAX metrics, port history) of STEPS detector steps."""
    from efficientsam3_tpu.train.stage3 import Stage3Config, make_stage3_optimizer
    from efficientsam3_tpu.train.stage3 import stage3_train_step as jstep

    jbatch, pbatch = batches
    jm = JModel(trunk=make_student_trunk("efficientvit", "b0", embed_size=8),
                text_encoder_type="MobileCLIP-S0", text_context_length=CTX,
                fusion_layers=1, decoder_layers=1)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, RES, RES, 3)), jbatch["tokens"][:1],
                            JPrompt.empty(1, 8, 8)), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=5)
    # the JAX script's optimizer and chunk loop (train_detector), metrics kept
    cfg = Stage3Config(vision_lr=LR, text_lr=LR, train_all=True, weight_decay=1e-4,
                       warmup_steps=200, timescale=STEPS, schedule="cosine")
    tx = make_stage3_optimizer(cfg, variables["params"])
    b = jbatch["images"].shape[0]
    full = dict(jbatch, prompt=JPrompt.empty(b, 4, 4), rng=jax.random.PRNGKey(42))

    def body(carry, _):
        v, o, m = jstep(jm, tx, *carry, full, loss_weights={"presence_loss": PRESENCE})
        return (v, o), m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        _, jmetrics = jax.jit(lambda v, o: jax.lax.scan(body, (v, o), jnp.arange(STEPS)))(
            variables, tx.init(variables["params"]))
    jmetrics = {k: np.asarray(v) for k, v in jmetrics.items()}

    pm = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_context_length=CTX, device="cpu",
        fusion_layers=1, decoder_layers=1, dropout=0.0)
    load_jax_variables(pm, variables)
    history = port_train.train_detector(pm, pbatch, STEPS, 2, LR,
                                        loss_weights={"presence_loss": PRESENCE})
    return jmetrics, history


def test_detector_loop_matches_jax_stage3_steps(runs):
    jmetrics, history = runs
    assert sorted(history) == sorted(jmetrics)
    assert all(len(v) == STEPS for v in history.values())
    assert history["loss"][-1] < history["loss"][0]
    for k, want in jmetrics.items():
        tol = 1e-3 if k == "grad_norm" else 1e-4
        for step, (g, w) in enumerate(zip(history[k], want)):
            assert abs(g - w) <= tol * max(1.0, abs(float(w))), (k, step, g, float(w))


def test_eval_quality_oracle_matches_jax():
    jmod = jax_script("eval_quality")
    want, got = jmod.oracle_metrics(), port_eval.oracle_metrics()
    assert got.keys() == want.keys() == {"perfect", "degraded_drop50"}
    assert got["perfect"]["cgF1"] >= 0.9999 and got["perfect"]["mask_AP"] == 1.0
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k, w in want[name].items():
            assert abs(got[name][k] - w) <= 1e-9, (name, k, got[name][k], w)
