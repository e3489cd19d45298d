"""The port's eval/distributed.py (torch.distributed) against the JAX
package's (jax.process_index / process_count): sharding and the filesystem
gather at explicit (index, count), the defaults without a process group,
and two gloo processes on the CPU (a file:// rendezvous, no TCP port) that
gather arrays and shard the gold harness."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from _torch_threads import THREADS

import efficientsam3_tpu.eval.distributed as jdist
import efficientsam3_tpu_torch.eval.distributed as pdist

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 60  # the two ranks together; a hang fails here, not at the suite's limit


@pytest.mark.parametrize("index,count", [(0, 1), (0, 3), (2, 3), (1, 4), (3, 4)])
def test_shard_for_process_matches_jax(index, count):
    items = [{"id": i} for i in range(10)]
    got = pdist.shard_for_process(items, index, count)
    assert got == jdist.shard_for_process(items, index, count)
    assert [x["id"] for x in got] == list(range(index, 10, count))


def test_defaults_without_a_group_match_jax():
    import torch.distributed as dist

    assert not dist.is_initialized()
    items = list(range(7))
    assert pdist.shard_for_process(items) == jdist.shard_for_process(items) == items
    x = np.arange(6.0).reshape(2, 3)
    assert pdist.all_gather_array(x) is x
    assert jdist.all_gather_array(x) is x


@pytest.mark.parametrize("writer,reader", [(jdist, pdist), (pdist, jdist), (pdist, pdist)],
                         ids=["jax_writes", "port_writes", "port_only"])
def test_filesystem_gather_matches_jax(tmp_path, writer, reader):
    """Rank 1 in a thread, rank 0 here, each with its own package: the
    pickles of one are read by the other, in rank order."""
    payloads = [{"rank": 0, "recs": [1.5, 2.5]}, {"rank": 1, "recs": ["a"]}]
    got = {}

    def rank1():
        got[1] = writer.all_gather_via_filesys(payloads[1], str(tmp_path), tag="t",
                                               timeout_s=30, process_index=1, process_count=2)

    th = threading.Thread(target=rank1)
    th.start()
    got[0] = reader.all_gather_via_filesys(payloads[0], str(tmp_path), tag="t", timeout_s=30,
                                           process_index=0, process_count=2)
    th.join(timeout=30)
    assert not th.is_alive()
    assert got[0] == got[1] == payloads
    assert sorted(os.listdir(tmp_path)) == ["t_0.pkl", "t_1.pkl"]


@pytest.mark.parametrize("impl", [jdist, pdist], ids=["jax", "port"])
def test_filesystem_gather_times_out(tmp_path, impl):
    with pytest.raises(TimeoutError, match="rank 1"):
        impl.all_gather_via_filesys(0, str(tmp_path), timeout_s=0.2, process_index=0,
                                    process_count=2)


_RANK = r"""
import json, sys
import numpy as np
import torch.distributed as dist
from efficientsam3_tpu_torch.eval import distributed as D
from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture, oracle_predict_fn
from efficientsam3_tpu_torch.eval.gold import run_gold_inference

rank, rdzv, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank, world_size=2)
try:
    x = np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank
    gathered = D.all_gather_array(x)
    ids = D.all_gather_array(np.asarray(rank + 5, np.int64))
    images, gt, _ = make_shapes_fixture(num_images=3, size=48, seed=2)

    def predict(img, phrase, pair_id):  # seeded by the pair: the same on any rank
        return oracle_predict_fn(images, gt, seed=pair_id)(img, phrase, pair_id)

    mine = run_gold_inference(predict, gt, lambda info: images[info["image_index"]])
    shards = D.all_gather_via_filesys(mine, out_dir + "/rdzv_gold", tag="gold")
    result = dict(rank=dist.get_rank(), size=dist.get_world_size(),
                  shard=D.shard_for_process(list(range(7))), gathered=gathered.tolist(),
                  gathered_shape=list(gathered.shape), ids=ids.tolist(),
                  mine=[r["image_id"] for r in mine], union=[r for s in shards for r in s])
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(result, f)
finally:
    dist.destroy_process_group()
"""


def test_two_gloo_ranks(tmp_path):
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture, oracle_predict_fn
    from efficientsam3_tpu_torch.eval.gold import run_gold_inference

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=str(THREADS))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(tmp_path / "rdzv"),
                               str(tmp_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(e[-2000:] for e in errs)
    out = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]

    images, gt, _ = make_shapes_fixture(num_images=3, size=48, seed=2)
    single = run_gold_inference(
        lambda img, q, pid: oracle_predict_fn(images, gt, seed=pid)(img, q, pid), gt,
        lambda info: images[info["image_index"]])
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, o in enumerate(out):
        assert (o["rank"], o["size"]) == (r, 2)
        assert o["shard"] == list(range(r, 7, 2))
        assert o["gathered_shape"] == [2, 2, 3]
        np.testing.assert_array_equal(o["gathered"], np.stack([base, base + 10]))
        assert o["ids"] == [5, 6]
        assert o["mine"] == [rec["image_id"] for rec in single if rec["image_id"] % 2 == r]
        key = lambda rec: (rec["image_id"], rec["score"])  # noqa: E731
        assert sorted(o["union"], key=key) == sorted(single, key=key)
    assert len(single) > 0
