"""Rules of the port's CUDA kernels that the CPU can check.

``flash_xattn_rpb``'s key splits: the wrapper's ``xattn_cluster`` picks
how many blocks split a query tile's keys (the thread-block cluster that
merges them), and the kernel gives split s the 64-key tiles
``xattn_split_tiles`` lists. Every key tile must fall in exactly one
split, and the count must be a cluster size the card schedules (1 to 8).

The depthwise kernels' partition (``depthwise.walk_runs``: the rows of
every (channel group, image, 36-column strip) laid end to end and cut into
one range a block): every output pixel falls in exactly one run, a run
computed from the rows and columns it stages (3 past it on every side, zero
outside the map) gives the plain forward, and the backward's dw / db,
summed a partial row per (block, group) and finished over
``depthwise.group_blocks`` in block order, count every pixel once.
LayerNorm's backward: its grid (``layer_norm.bwd_grid``) reaches every row
once on each path and its finish groups every block once.

The sources: no kernel under ``csrc/`` issues ``mma.sync`` (every
attention kernel and the tensor-core probe ``mma_probe.cu`` are on wgmma),
the mma.sync helpers' header ``attn_common.cuh`` is gone, and no module of
the port but ``ops/rms_norm.py`` reaches Triton (``ops/layer_norm.py`` not),
there for the forward alone (the backward is ``csrc/layer_norm.cu``'s).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

from efficientsam3_tpu_torch.ops import _build
from efficientsam3_tpu_torch.ops import depthwise as dw
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.ops import layer_norm as ln

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
    """No source issues mma.sync, the probe included: it times the wgmma
    instructions the bank kernels use, int8 and bf16."""
    code = _code(path)
    assert "mma.sync" not in code and "mma16816" not in code
    if path.name == "mma_probe.cu":
        assert "wgmma.mma_async" in code and "wgmma_s8_rs" in code and "wgmma_rs<0>" in code
    assert not re.search(r'#include\s+"attn_common\.cuh"', code)


def test_attn_common_is_gone():
    assert not (CSRC / "attn_common.cuh").exists()


# ---- the depthwise kernels' walk

# (B, H, W, C): the tracker memory encoder's fuser, ragged maps and channel
# counts (element-copy staging), a map smaller than the taps
DW_SHAPES = [(8, 72, 72, 256), (1, 13, 17, 36), (1, 7, 7, 8), (2, 13, 29, 40), (1, 9, 5, 37),
             (3, 11, 40, 33), (1, 3, 4, 1)]
# blocks: the forward's and the backward's on an H100 (2 and 1 an SM), and others
DW_GRIDS = [264, 132, 7, 1]


def _grid(shape, grid):
    b, h, w, c = shape
    total = -(-c // dw.CHANNELS_A_BLOCK) * b * -(-w // dw.STRIP) * h
    return min(grid, total)  # the kernel's rule: at least one row a block


@pytest.mark.parametrize("shape", DW_SHAPES, ids=str)
@pytest.mark.parametrize("grid", DW_GRIDS)
def test_depthwise_walk_covers_every_output_once(shape, grid):
    b, h, w, c = shape
    grid = _grid(shape, grid)
    runs = dw.walk_runs(b, h, w, c, grid)
    hits = np.zeros(shape, np.int32)
    per_block = []
    for blk_runs in runs:
        per_block.append(sum(i1 - i0 for *_, i0, i1 in blk_runs))
        for group, image, strip, i0, i1 in blk_runs:
            assert 0 <= i0 < i1 <= h and 0 <= image < b
            x0, c0 = strip * dw.STRIP, group * dw.CHANNELS_A_BLOCK
            assert x0 < w and c0 < c
            hits[image, i0:i1, x0:x0 + dw.STRIP, c0:c0 + dw.CHANNELS_A_BLOCK] += 1
    assert (hits == 1).all()
    assert min(per_block) >= 1 and max(per_block) - min(per_block) <= 1  # balanced


def _staged_window(a, image, strip, i0, i1):
    """The rows and columns a run stages, as the kernel holds them: rows i0
    - 3 .. i1 + 3 and the strip's columns with 3 on each side, zero where
    they fall outside the map; the run's origin in the window."""
    b, h, w, c = a.shape
    p, x0 = 3, strip * dw.STRIP
    win = torch.zeros((i1 - i0 + 2 * p, dw.STRIP + 2 * p, c), dtype=a.dtype)
    r0, r1 = max(0, i0 - p), min(h, i1 + p)
    q0, q1 = max(0, x0 - p), min(w, x0 + dw.STRIP + p)
    win[r0 - (i0 - p):r1 - (i0 - p), q0 - (x0 - p):q1 - (x0 - p)] = a[image, r0:r1, q0:q1]
    return win


@pytest.mark.parametrize("shape", DW_SHAPES[1:], ids=str)
@pytest.mark.parametrize("grid", DW_GRIDS[1:])
def test_depthwise_runs_from_their_staged_rows_give_the_plain_results(shape, grid):
    """Each run computes its outputs from its staged window alone (the
    halo reads in the map or zero), and the backward's dw / db, one partial
    a (block, channel group) at slot block + group, summed per group over
    group_blocks in block order, equal the plain sums: each pixel counted
    once."""
    b, h, w, c = shape
    grid = _grid(shape, grid)
    rng = np.random.default_rng(sum(shape) + grid)
    x, g = (torch.from_numpy(rng.standard_normal(shape)).double() for _ in range(2))
    kernel = torch.from_numpy(rng.standard_normal((7, 7, 1, c))).double()
    bias = torch.from_numpy(rng.standard_normal(c)).double()
    want = dw.depthwise_conv2d_plain(x, kernel, bias)
    _, want_dw, want_db = dw.depthwise_conv2d_bwd_plain(x, kernel, g)
    groups = -(-c // dw.CHANNELS_A_BLOCK)
    y = torch.full(shape, float("nan"), dtype=torch.float64)
    part = {}
    for blk, blk_runs in enumerate(dw.walk_runs(b, h, w, c, grid)):
        for group, image, strip, i0, i1 in blk_runs:
            x0, c0 = strip * dw.STRIP, group * dw.CHANNELS_A_BLOCK
            cs = slice(c0, min(c, c0 + dw.CHANNELS_A_BLOCK))
            cols = min(w, x0 + dw.STRIP) - x0
            win = _staged_window(x, image, strip, i0, i1)[..., cs]
            out = bias[cs] + sum(kernel[di, dj, 0, cs] * win[di:di + i1 - i0, dj:dj + cols]
                                 for di in range(7) for dj in range(7))
            y[image, i0:i1, x0:x0 + cols, cs] = out
            gr = g[image, i0:i1, x0:x0 + cols, cs]
            sums = torch.stack([(win[di:di + i1 - i0, dj:dj + cols] * gr).sum((0, 1))
                                for di in range(7) for dj in range(7)] + [gr.sum((0, 1))])
            slot = blk + group
            assert slot < grid + groups
            key = part.setdefault(slot, (blk, group, torch.zeros((50, cs.stop - c0),
                                                                  dtype=torch.float64)))
            assert key[:2] == (blk, group)  # one (block, group) a slot
            key[2].add_(sums)
    # the plain versions sum in fp32: ~1e-6 of the sums' magnitude
    torch.testing.assert_close(y, want.double(), rtol=1e-5, atol=1e-4)
    dwb = torch.zeros((50, c), dtype=torch.float64)
    for group in range(groups):
        first, last = dw.group_blocks(b, h, w, c, grid, group)
        touching = sorted(k for k, (blk, grp, _) in part.items() if grp == group)
        assert [part[k][0] for k in touching] == list(range(first, last + 1))
        c0 = group * dw.CHANNELS_A_BLOCK
        for k in touching:
            dwb[:, c0:c0 + part[k][2].shape[1]] += part[k][2]
    torch.testing.assert_close(dwb[:49].reshape(7, 7, 1, c), want_dw.double(), rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(dwb[49], want_db.double(), rtol=1e-5, atol=1e-4)


# ---- LayerNorm's backward grid


@pytest.mark.parametrize("nb,n", [(4, 5184), (1, 5184), (1, 17), (2, 999), (1, 1), (3, 201)])
@pytest.mark.parametrize("resident", [132 * 1, 132 * 4, 5])
def test_layer_norm_bwd_grid_reaches_every_row_once(nb, n, resident):
    """Persistent blocks: on the vector path warp w of block k walks rows k *
    16 + w at the stride of the grid's warps; on the column path block k
    walks tiles of 16 rows of one image at the grid's stride; on the masked
    path block k walks rows at the grid's stride. The finish puts each
    block in one group of at most ceil(sqrt(grid)) blocks, and the scratch
    the wrapper allots (4 blocks an SM and their groups) holds every grid."""
    rows, warps = nb * n, ln.BWD_WARPS
    grid, _, _ = ln.bwd_grid(nb, n, "vector", resident)
    hits = np.zeros(rows, np.int32)
    for k in range(grid):
        for wv in range(warps):
            hits[k * warps + wv::grid * warps] += 1
    assert (hits == 1).all() and 1 <= grid <= resident
    tiles = -(-n // ln.BWD_TILE)
    grid_c, _, _ = ln.bwd_grid(nb, n, "column", resident)
    hits = np.zeros((nb, tiles * ln.BWD_TILE), np.int32)
    for k in range(grid_c):
        for tile in range(k, nb * tiles, grid_c):
            image, t = divmod(tile, tiles)
            hits[image, t * ln.BWD_TILE:(t + 1) * ln.BWD_TILE] += 1
    assert (hits[:, :n] == 1).all() and 1 <= grid_c <= resident
    grid_m, _, _ = ln.bwd_grid(nb, n, "masked", resident)
    hits = np.zeros(rows, np.int32)
    for k in range(grid_m):
        hits[k::grid_m] += 1
    assert (hits == 1).all()
    most = ln.BWD_BLOCKS_PER_SM * 132
    _, _, most_groups = ln.bwd_grid(1, most, "masked", most)
    for gr in (grid, grid_c, grid_m):
        _, gsize, groups = ln.bwd_grid(1, gr, "masked", gr)
        members = [min(gsize, gr - i * gsize) for i in range(groups)]
        assert sum(members) == gr and min(members) >= 1 and gsize * gsize >= gr
        if resident <= most:
            assert gr + groups <= most + most_groups and groups + 1 <= most_groups + 1


def test_layer_norm_bwd_reads_batched_channel_major_maps_in_place():
    """The Stage-3 step's norms see (4, 5184, 256) channel-major views (a
    (4, 256, 5184) map transposed): their axes merge into no single row
    axis, and the backward reads them at (batch, row, column) strides, no
    copy; an x row-major beside a channel-major g splits its rows the same
    way; a layout no two axes describe is copied."""
    x = torch.zeros(4, 256, 5184).transpose(1, 2)
    g = torch.zeros(4, 5184, 256)
    nb, n, sx, sg, x2, g2 = ln._batch_rows(x, g)
    assert (nb, n, sx, sg) == (4, 5184, (1327104, 1, 5184), (1327104, 256, 1))
    assert x2.data_ptr() == x.data_ptr() and g2.data_ptr() == g.data_ptr()
    nb, n, sx, sg, _, _ = ln._batch_rows(g, g)
    assert (nb, n, sx) == (1, 4 * 5184, (4 * 5184 * 256, 256, 1))
    odd = torch.zeros(2, 5, 3, 16).permute(0, 2, 1, 3)
    _, _, _, _, x3, _ = ln._batch_rows(odd, odd.contiguous())
    assert x3.is_contiguous() and x3.data_ptr() != odd.data_ptr()
    for t in (x, g, odd):  # the strides name every element where it lies
        nb, n, (sb, sn, sc), _, t2, _ = ln._batch_rows(t, t)
        flat = torch.as_strided(t2, (nb, n, t.shape[-1]), (sb, sn, sc))
        torch.testing.assert_close(flat.reshape(t.shape), t)


def test_layer_norm_module_reaches_no_triton():
    """LayerNorm's forward and backward are CUDA (csrc/layer_norm.cu); of the
    port's modules only ops/rms_norm.py imports Triton."""
    ops = Path(ln.__file__).parent
    assert "triton" not in Path(ln.__file__).read_text().lower()
    users = sorted(p.name for p in Path(ops.parent).rglob("*.py")
                   if re.search(r"^\s*import triton", p.read_text(), re.M))
    assert users == ["rms_norm.py"]


def test_rms_norm_backward_reaches_no_triton():
    """rms_norm_2d's backward is one launch of csrc/layer_norm.cu's
    rms_norm_bwd (dw and db finished in the launch): Triton's kernels are
    the forward's alone, and no sum follows the launch."""
    import inspect

    from efficientsam3_tpu_torch.ops import rms_norm as rn

    bwd = inspect.getsource(rn.rms_norm_2d_bwd)
    assert "triton" not in bwd.lower() and "_lib_bwd()" in bwd and ".sum(" not in bwd
    assert "_rms_bwd" not in inspect.getsource(rn)
    assert "rms_norm_bwd(" in _code(CSRC / "layer_norm.cu")
