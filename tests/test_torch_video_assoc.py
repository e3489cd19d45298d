"""The port's video association training against the JAX package's, in fp32
on the CPU: ``AssocHead``'s logits and the association loss's gradient
against JAX's on the same variables, ``FramePairDataset``'s batches equal
to JAX's from the same seed, and a falling loss over 40 steps of
``assoc_train_step`` (JAX's smoke scenario)."""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.train import losses as jl
from efficientsam3_tpu.train import video_assoc as jva
from efficientsam3_tpu_torch.build import init_parameters
from efficientsam3_tpu_torch.train.losses import det2trk_assoc_loss
from efficientsam3_tpu_torch.train import video_assoc as pva
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables
from test_torch_train_slice import random_variables


@pytest.mark.parametrize("d_model,q_det,q_trk", [(32, 12, 6), (64, 20, 8)])
def test_assoc_head_and_loss_match_jax(d_model, q_det, q_trk):
    """Logits within 1e-5, and the loss's gradient w.r.t. every parameter
    within 1e-5 of each tensor's largest magnitude."""
    batch = jva.FramePairDataset(q_det, q_trk, d_model, seed=3).batch(4)
    jh = jva.AssocHead(d_model=d_model)
    shapes = jax.eval_shape(jh.init, jax.random.PRNGKey(0), batch["det_queries"],
                            batch["trk_queries"])
    variables = random_variables(shapes, seed=7)
    want = jh.apply(variables, batch["det_queries"], batch["trk_queries"])
    ph = load_jax_variables(pva.AssocHead(d_model), variables)
    det, trk, ids = (torch.from_numpy(batch[k]) for k in
                     ("det_queries", "trk_queries", "matched_object_ids"))
    got = ph(det, trk)
    assert got.shape == (4, q_det, q_trk + 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    num_boxes = max(float((batch["matched_object_ids"][:, :q_det] >= 0).sum()), 1.0)
    jgrads = jax.grad(lambda p: jl.det2trk_assoc_loss(
        jh.apply({"params": p}, batch["det_queries"], batch["trk_queries"]),
        jnp.asarray(batch["matched_object_ids"]), num_boxes))(variables["params"])
    det2trk_assoc_loss(got, ids, num_boxes).backward()
    for k, w in convert_variables({"params": jgrads}).items():
        g = dict(ph.named_parameters())[k].grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-6))


def test_frame_pair_batches_match_jax():
    """The same seed gives the same batches, in order."""
    a = jva.FramePairDataset(q_det=10, q_trk=5, d_model=16, seed=11)
    b = pva.FramePairDataset(q_det=10, q_trk=5, d_model=16, seed=11)
    for _ in range(3):
        ja, pb = a.batch(3), b.batch(3)
        assert ja.keys() == pb.keys()
        for k in ja:
            np.testing.assert_array_equal(ja[k], pb[k])
            assert ja[k].dtype == pb[k].dtype


def test_assoc_head_training_loss_falls():
    """JAX's smoke scenario on the port: Adam at 3e-3, 40 steps of batch 2
    on FramePairDataset(d_model=32, seed=1); the mean of the last 5 losses
    under half that of the first 5."""
    ds = pva.FramePairDataset(d_model=32, seed=1)
    torch.manual_seed(0)
    head = init_parameters(pva.AssocHead(d_model=32), seed=0)
    step = pva.assoc_train_step(head, torch.optim.Adam(head.parameters(), lr=3e-3))
    losses = [float(step(ds.batch(2))) for _ in range(40)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5]), losses[:5] + losses[-5:]
