"""Rules of the port's CUDA kernels that the CPU can check.

``flash_xattn_rpb``'s key splits: the wrapper's ``xattn_cluster`` picks
how many blocks split a query tile's keys (the thread-block cluster that
merges them), and the kernel gives split s the 64-key tiles
``xattn_split_tiles`` lists. Every key tile must fall in exactly one
split, and the count must be a cluster size the card schedules (1 to 8).

The sources: no kernel under ``csrc/`` but the measurement tool
``mma_probe.cu`` issues ``mma.sync`` (every attention kernel is on wgmma),
and the mma.sync helpers' header ``attn_common.cuh`` is gone.
"""

import re
from pathlib import Path

import pytest

from efficientsam3_tpu_torch.ops import _build
from efficientsam3_tpu_torch.ops import flash_attention as fa

CSRC = Path(_build.CSRC)

# (batch x heads, queries, map): the decoder's in `ground` and a PCS frame
# (8 heads, 201 queries, 72 x 72), at batch 2 and 4, the tiny test
# configs' maps, ragged query counts and maps, the largest map the kernel
# takes (127 x 127)
SHAPES = [(8, 201, (72, 72)), (16, 201, (72, 72)), (32, 201, (72, 72)), (8, 201, (5, 7)),
          (8, 1, (3, 5)), (8, 65, (8, 8)), (24, 130, (127, 127)), (8, 201, (1, 100)),
          (1, 7, (18, 27)), (200, 201, (72, 72))]


def _resident(sms, per_sm):
    """Clusters of a size the card holds at once, as a card whose clusters
    use all but 8 of its SMs would (the H100's GPCs leave some out)."""
    return lambda splits: (sms - 8) * per_sm // splits


@pytest.mark.parametrize("bh,lq,hw", SHAPES)
@pytest.mark.parametrize("num_sms,per_sm", [(132, 2), (132, 1), (114, 2), (16, 1)])
def test_xattn_splits_cover_every_key_tile_once(bh, lq, hw, num_sms, per_sm):
    lk = hw[0] * hw[1]
    k_tiles = -(-lk // 64)
    resident = _resident(num_sms, per_sm)
    splits = fa.xattn_cluster(bh, lq, lk, num_sms * per_sm, resident)
    assert 1 <= splits <= min(8, k_tiles)
    tiles = fa.xattn_split_tiles(k_tiles, splits)
    assert len(tiles) == splits
    covered = [t for a, b in tiles for t in range(a, b)]
    assert covered == list(range(k_tiles))  # each tile once, in split order
    assert all(b > a for a, b in tiles)  # no split is empty
    sizes = [b - a for a, b in tiles]
    assert max(sizes) - min(sizes) <= 1
    q_tiles = -(-lq // 64)
    if splits > 1:  # the grid stays one wave: within the slots, every cluster resident
        assert splits * q_tiles * bh <= num_sms * per_sm
        assert q_tiles * bh <= resident(splits)


def test_xattn_cluster_at_the_decoder_shape():
    """The decoder's (1, 8, 201, 32) x 5184 keys, 32 clusters, on 132 SMs
    at two blocks an SM: 8 splits would fill 256 of 264 slots, but only 31
    clusters of 8 are resident, so 7; unlimited clusters 8; at batch 2 (64
    clusters, 62 of 4 resident) 3; 1 when the query tiles alone fill the
    card."""
    resident = _resident(132, 2)
    assert fa.xattn_cluster(8, 201, 5184, 264, resident) == 7
    assert fa.xattn_cluster(8, 201, 5184, 264) == 8
    assert fa.xattn_cluster(16, 201, 5184, 264, resident) == 3
    assert fa.xattn_cluster(200, 201, 5184, 264, resident) == 1
    assert fa.xattn_split_tiles(81, 8)[-1] == (70, 81)


def _code(path):
    """The source without its comments."""
    text = path.read_text()
    return re.sub(r"/\*.*?\*/", "", re.sub(r"//[^\n]*", "", text), flags=re.S)


@pytest.mark.parametrize("path", sorted(CSRC.glob("*.cu*")), ids=lambda p: p.name)
def test_no_kernel_but_the_probe_issues_mma_sync(path):
    code = _code(path)
    if path.name == "mma_probe.cu":
        assert "mma.sync.aligned" in code  # the tool that times it
    else:
        assert "mma.sync" not in code and "mma16816" not in code
    assert not re.search(r'#include\s+"attn_common\.cuh"', code)


def test_attn_common_is_gone():
    assert not (CSRC / "attn_common.cuh").exists()
