"""SAM2-style VOS predictor over the TrackerCore (host side).

Counterpart of efficientsam3_tpu/video/predictor.py: ``init_state`` /
``add_new_points_or_box`` / ``add_new_mask`` / ``propagate_in_video`` /
``remove_object``, with per-object outputs kept per frame. Objects sit in a
fixed number of slots (``obj_slots``), the batch of every core call, and
the memory bank is assembled per frame from small host-side index logic
(closest conditioning frames, the stride-r window of recent frames, or the
SAM2Long-style memory selection).

By default (``cache_memory_kv``) each frame's memory keys are projected
once, when the frame is encoded, and the bank lives on the device as one
persistent flat array (``state["kv_bank"]``) whose columns are rewritten in
place as frames enter the window. When the slots select different frames
for a bank column (an object prompted on a later frame), the frame falls
back to the plain path, which projects the gathered memory per frame.

``quantize_bank`` attends the cached bank through int8 keys
(``flash_memattn_q8`` on CUDA); ``fill_hole_area > 0`` fills small holes and
drops small sprinkles of the yielded masks on the host.

Object-parallel tracking (``mesh`` with an ``mesh_axis`` of n ranks, n
dividing ``obj_slots``): the four per-slot programs (track, prompted-frame
track, memory encoding, mask adoption) run through
``parallel.object_parallel``, each rank on its obj_slots / n slots, their
outputs all-gathered; the frame features are computed on every rank and
every rank keeps the host-side plan on the gathered outputs. The cached
bank is single-device, so under a mesh ``cache_memory_kv`` is off and the
tracker takes the plain path, as in the JAX package.

Per-frame outputs stay on the core's device; ``propagate_in_video`` yields
(frame_idx, obj_ids, low-res mask logits (n_obj, 1, 288, 288)).
"""

from __future__ import annotations

import numpy as np
import torch

from efficientsam3_tpu_torch.models.common import sine_pos_embed_2d
from efficientsam3_tpu_torch.ops.cc import fill_holes_in_mask_scores_host
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear
from efficientsam3_tpu_torch.parallel.sharding import object_parallel
from efficientsam3_tpu_torch.video.tracker import TrackerCore, flatten_kv_bank

_SLOT_KEYS = ("low_res_masks", "obj_ptr", "object_score_logits", "maskmem", "slot_valid")


def select_closest_cond_frames(frame_idx, cond_indices, max_num, keep_first=False):
    """The temporally closest conditioning frames: (selected, unselected)."""
    if max_num == -1 or len(cond_indices) <= max_num:
        return list(cond_indices), []
    selected = set()
    if keep_first:
        selected.add(min(cond_indices))
    before = [t for t in cond_indices if t < frame_idx]
    after = [t for t in cond_indices if t >= frame_idx]
    if before:
        selected.add(max(before))
    if after:
        selected.add(min(after))
    rest = sorted((t for t in cond_indices if t not in selected), key=lambda t: abs(t - frame_idx))
    for t in rest:
        if len(selected) >= max_num:
            break
        selected.add(t)
    return sorted(selected), [t for t in cond_indices if t not in selected]


class TrackerPredictor:
    """VOS predictor over per-frame features from ``encode_frame``: image
    (1, H, W, 3) float -> dict whose 'sam2_fpn' holds the NHWC levels (the
    image model's ``encode_image``)."""

    def __init__(self, core: TrackerCore, encode_frame, obj_slots: int = 8,
                 max_cond_frames_in_attn: int = 4, memory_temporal_stride: int = 1,
                 max_point_prompts: int = 8, trim_past_non_cond_mem: bool = True,
                 use_memory_selection: bool = False, mf_threshold: float = 0.01,
                 fill_hole_area: int = 0, cache_memory_kv: bool = True,
                 quantize_bank: bool = False, mesh=None, mesh_axis: str = "objects"):
        self.core = core
        self.encode_frame = encode_frame
        self.obj_slots = obj_slots
        self.max_cond = max_cond_frames_in_attn
        self.stride = memory_temporal_stride
        self.max_points = max_point_prompts
        self.trim_past_non_cond_mem = trim_past_non_cond_mem
        self.use_memory_selection = use_memory_selection
        self.mf_threshold = mf_threshold
        # the cached bank is single-device: under a mesh, the plain path
        self.cache_kv = cache_memory_kv and mesh is None
        self.quantize_bank = quantize_bank
        self.fill_hole_area = fill_hole_area
        self.device = next(core.parameters()).device
        self._kv_delta = None  # core.tpos_k_delta(), made on first use
        self._kv_zero = None  # zero (k, v) entry for empty bank columns
        fs, d = core.feat_size, core.d_model
        self._pos = sine_pos_embed_2d(fs, fs, d, device=self.device).reshape(fs * fs, d)
        if mesh is not None:
            n = mesh.size(mesh.mesh_dim_names.index(mesh_axis))
            if obj_slots % n != 0:
                raise ValueError(f"obj_slots={obj_slots} not divisible by mesh axis "
                                 f"{mesh_axis}={n}")
            self._track = object_parallel(self._track, mesh, mesh_axis, n_array_args=11)
            self._cond_track = object_parallel(self._cond_track, mesh, mesh_axis, 5)
            self._encode_mem = object_parallel(self._encode_mem, mesh, mesh_axis, 3)
            self._cond_mask = object_parallel(self._cond_mask, mesh, mesh_axis, 4)

    # the per-slot programs: every argument before the last ones carries
    # object slots on its leading axis (object_parallel splits them)

    def _pix(self, tokens):
        fs = self.core.feat_size
        return self.core.no_mem_features(tokens).reshape(tokens.shape[0], fs, fs, -1)

    def _track(self, tokens, mem, tpos, valid, ptrs, tdiff, pvalid, coords, labels, s0, s1,
               max_tdiff):
        core, fs = self.core, self.core.feat_size
        cond = core.condition_features(tokens, self._pos, mem, tpos, valid, ptrs, tdiff, pvalid,
                                       max_tdiff)
        return core.forward_sam_heads(cond.reshape(tokens.shape[0], fs, fs, core.d_model),
                                      coords, labels, (s0, s1), True)

    def _cond_track(self, tokens, coords, labels, s0, s1, multimask):
        return self.core.forward_sam_heads(self._pix(tokens), coords, labels, (s0, s1),
                                           multimask)

    def _encode_mem(self, tokens, high_res_masks, score, from_pts):
        return self.core.encode_memory(tokens, high_res_masks, score, from_pts)

    def _cond_mask(self, tokens, masks, s0, s1):
        return self.core.use_mask_as_output(self._pix(tokens), (s0, s1), masks)

    # ------------------------------------------------------------------

    def init_state(self, frames) -> dict:
        """frames: (T, H, W, 3) array or tensor, or a list of frames
        (encoded when first needed)."""
        return {
            "frames": frames,
            "num_frames": len(frames),
            "feat_cache": {},
            "obj_ids": [],  # user object ids, slot-aligned
            "cond_frames": {},  # frame_idx -> per-slot outputs
            "non_cond_frames": {},
            "prompts": {},  # frame_idx -> (coords, labels) per slot
        }

    def _features(self, state, frame_idx):
        if frame_idx not in state["feat_cache"]:
            f = state["frames"][frame_idx]
            if isinstance(f, torch.Tensor):
                img = f.to(self.device, torch.float32)[None]
            else:
                img = torch.as_tensor(np.asarray(f, np.float32), device=self.device)[None]
            fpn = self.encode_frame(img)["sam2_fpn"]
            s0, s1 = self.core.sam_mask_decoder.high_res_convs(fpn[0], fpn[1])
            fs = self.core.feat_size
            tokens = fpn[2].reshape(1, fs * fs, self.core.d_model)
            state["feat_cache"][frame_idx] = (tokens, s0, s1)
        return state["feat_cache"][frame_idx]

    def _slot(self, state, obj_id) -> int:
        if obj_id in state["obj_ids"]:
            return state["obj_ids"].index(obj_id)
        if len(state["obj_ids"]) >= self.obj_slots:
            raise ValueError(f"too many objects (max {self.obj_slots})")
        state["obj_ids"].append(obj_id)
        return len(state["obj_ids"]) - 1

    def _tile(self, x):
        """Broadcast single-frame features to the object-slot batch."""
        return x.expand(self.obj_slots, *x.shape[1:])

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    @torch.inference_mode()
    def add_new_points_or_box(self, state, frame_idx: int, obj_id, points=None, labels=None,
                              box=None):
        """points (P, 2) pixel xy at the model's input resolution, labels (P,)
        1/0; box (4,) xyxy, as two corner points labelled 2/3."""
        slot = self._slot(state, obj_id)
        pts = np.zeros((self.max_points, 2), np.float32)
        labs = -np.ones((self.max_points,), np.int64)
        n = 0
        if box is not None:
            pts[0], pts[1] = box[:2], box[2:]
            labs[0], labs[1] = 2, 3
            n = 2
        if points is not None:
            p = np.asarray(points, np.float32)
            pts[n:n + len(p)] = p
            labs[n:n + len(p)] = np.asarray(labels, np.int64)
        prompts = state["prompts"].setdefault(frame_idx, (
            np.zeros((self.obj_slots, self.max_points, 2), np.float32),
            -np.ones((self.obj_slots, self.max_points), np.int64)))
        prompts[0][slot] = pts
        prompts[1][slot] = labs

        out = self._run_cond_frame(state, frame_idx)
        state["cond_frames"][frame_idx] = out
        # other objects' tracked outputs at this frame stay usable; only the
        # prompted slots move to the conditioning outputs
        nc = state["non_cond_frames"].get(frame_idx)
        if nc is not None:
            nc["slot_valid"] = nc["slot_valid"] & ~out["slot_valid"]
            if not nc["slot_valid"].any():
                state["non_cond_frames"].pop(frame_idx, None)
        return frame_idx, list(state["obj_ids"]), out["low_res_masks"][:len(state["obj_ids"])]

    @torch.inference_mode()
    def add_new_mask(self, state, frame_idx: int, obj_id, mask):
        """Adopt a binary mask (H, W) at any resolution as this object's
        output on a prompted frame."""
        core = self.core
        slot = self._slot(state, obj_id)
        tokens, s0, s1 = self._features(state, frame_idx)
        r = core.image_size
        m = self._tensor(np.asarray(mask, np.float32))[None, None]
        if tuple(m.shape[-2:]) != (r, r):
            m = (resize_bilinear(m, (r, r)) > 0.5).float()
        masks = torch.zeros((self.obj_slots, r, r, 1), device=self.device)
        masks[slot, :, :, 0] = m[0, 0]
        heads = self._cond_mask(self._tile(tokens), masks, self._tile(s0), self._tile(s1))
        mem = self._encode_mem(self._tile(tokens), heads["high_res_masks"],
                               heads["object_score_logits"], True)
        sv = np.zeros((self.obj_slots,), bool)
        sv[slot] = True
        new_out = {"low_res_masks": heads["low_res_masks"], "obj_ptr": heads["obj_ptr"],
                   "object_score_logits": heads["object_score_logits"], "maskmem": mem,
                   "slot_valid": sv}
        # merge the new slot's row into any outputs this frame already has
        existing = state["cond_frames"].get(frame_idx) or state["non_cond_frames"].get(frame_idx)
        if existing is not None and "maskmem" in existing:
            for k, v in new_out.items():
                if k == "slot_valid":
                    existing[k][slot] = True
                else:
                    existing[k][slot] = v[slot]
            out = existing
        else:
            out = new_out
        if self.cache_kv:
            out["mem_kv"] = core.encode_memory_kv(out["maskmem"])
        state["cond_frames"][frame_idx] = out
        state["non_cond_frames"].pop(frame_idx, None)
        return frame_idx, list(state["obj_ids"]), out["low_res_masks"][:len(state["obj_ids"])]

    def _run_cond_frame(self, state, frame_idx):
        """The prompted-frame path at each object's exact prompt width: n
        clicks + one pad point (the prompt encoder always appends one, and
        the two-way transformer attends to it). Slots are grouped by width."""
        core = self.core
        tokens, s0, s1 = self._features(state, frame_idx)
        coords_all, labs_all = state["prompts"][frame_idx]
        n_per_slot = (labs_all >= 0).sum(axis=1)
        prompted = np.where(n_per_slot > 0)[0]
        s_n, lr, fs = self.obj_slots, core.low_res_mask_size, core.feat_size
        dev = self.device
        out = {
            "low_res_masks": torch.zeros((s_n, 1, lr, lr), device=dev),
            "obj_ptr": torch.zeros((s_n, core.d_model), device=dev),
            "object_score_logits": torch.zeros((s_n, 1), device=dev),
            "maskmem": torch.zeros((s_n, fs, fs, core.mem_dim), device=dev),
            "slot_valid": np.zeros((s_n,), bool),
        }
        for w in sorted({int(n_per_slot[s]) + 1 for s in prompted}):
            group = [int(s) for s in prompted if int(n_per_slot[s]) + 1 == w]
            coords_w = np.zeros((s_n, w, 2), np.float32)
            labs_w = -np.ones((s_n, w), np.int64)
            coords_w[:, :w - 1] = coords_all[:, :w - 1]
            labs_w[:, :w - 1] = labs_all[:, :w - 1]
            # multimask iff at most one click (a box counts as two points)
            heads = self._cond_track(self._tile(tokens), self._tensor(coords_w),
                                     self._tensor(labs_w), self._tile(s0), self._tile(s1),
                                     (w - 1) <= 1)
            mem = self._encode_mem(self._tile(tokens), heads["high_res_masks"],
                                   heads["object_score_logits"], True)
            g = self._tensor(group)
            out["low_res_masks"][g] = heads["low_res_masks"][g]
            out["obj_ptr"][g] = heads["obj_ptr"][g]
            out["object_score_logits"][g] = heads["object_score_logits"][g]
            out["maskmem"][g] = mem[g]
            out["slot_valid"][group] = True
        if self.cache_kv:
            out["mem_kv"] = core.encode_memory_kv(out["maskmem"])
        return out

    # ------------------------------------------------------------------

    @staticmethod
    def _slot_ok(out, s):
        sv = out.get("slot_valid")
        return sv is None or bool(sv[s])

    def _frame_filter(self, state, reverse, frame_idx, r):
        """SAM2Long-style memory selection: walk back at stride r and keep
        frames whose effective IoU score clears mf_threshold; always
        include the neighbouring frame."""
        num_frames = state["num_frames"]
        if (frame_idx == 0 and not reverse) or (frame_idx == num_frames - 1 and reverse):
            return []
        max_num = min(num_frames, self.core.max_obj_ptrs)
        if not reverse:
            scan, must_include = range(frame_idx - 1, -1, -r), frame_idx - 1
        else:
            scan, must_include = range(frame_idx + 1, num_frames, r), frame_idx + 1
        valid_indices = []
        for i in scan:
            out = state["non_cond_frames"].get(i)
            if out is None or "eff_iou_score" not in out:
                continue
            if out["eff_iou_score"] > self.mf_threshold:
                valid_indices.insert(0, i)
            if len(valid_indices) >= max_num - 1:
                break
        if must_include not in valid_indices:
            valid_indices.append(must_include)
        return valid_indices

    def _gather_memory(self, state, frame_idx, reverse=False):
        """The bank's host-side index logic, per slot: each object attends
        only to frames where it has outputs. Returns (mem_refs, tpos,
        valid, ptrs, tdiff, pvalid, src): mem_refs [(slot, column, out)]
        locates the spatial memories (stacked only on the plain path), src
        (slots, n_mem) the source frame of each column (-1 empty)."""
        core = self.core
        n_mem = core.num_maskmem
        tpos = np.zeros((self.obj_slots, n_mem), np.int64)
        valid = np.zeros((self.obj_slots, n_mem), bool)
        ptrs = torch.zeros((self.obj_slots, core.max_obj_ptrs, core.d_model), device=self.device)
        tdiff = np.zeros((self.obj_slots, core.max_obj_ptrs), np.float32)
        pvalid = np.zeros((self.obj_slots, core.max_obj_ptrs), bool)
        src = -np.ones((self.obj_slots, n_mem), np.int64)
        mem_refs = []
        r = self.stride
        sign = -1 if reverse else 1
        cond, non_cond = state["cond_frames"], state["non_cond_frames"]

        for s in range(len(state["obj_ids"])):
            cond_ts = sorted(t for t, o in cond.items() if self._slot_ok(o, s))
            if not cond_ts:
                continue
            cond_idx, unsel = select_closest_cond_frames(frame_idx, cond_ts, self.max_cond)
            slot_i = 0
            for t in cond_idx[:n_mem]:
                mem_refs.append((s, slot_i, cond[t]))
                valid[s, slot_i] = True
                src[s, slot_i] = t
                slot_i += 1

            def mem_lookup(t):
                out = non_cond.get(t)
                if out is None and t in unsel:
                    out = cond.get(t)
                if out is None or "maskmem" not in out or not self._slot_ok(out, s):
                    return None
                return out

            # recent non-conditioning frames at stride r, or the selected ones
            if self.use_memory_selection:
                vi = self._frame_filter(state, reverse, frame_idx, r)
            for t_pos in range(1, n_mem):
                t_rel = n_mem - t_pos
                if self.use_memory_selection:
                    if t_rel > len(vi):
                        continue
                    prev = vi[-t_rel]
                elif t_rel == 1:
                    prev = frame_idx - sign
                elif not reverse:
                    prev = ((frame_idx - 2) // r) * r - (t_rel - 2) * r
                else:
                    prev = -(-(frame_idx + 2) // r) * r + (t_rel - 2) * r
                out = mem_lookup(prev)
                if out is None or slot_i >= n_mem:
                    continue
                mem_refs.append((s, slot_i, out))
                tpos[s, slot_i] = t_pos
                valid[s, slot_i] = True
                src[s, slot_i] = prev
                slot_i += 1

            # object pointers: conditioning frames (past only), then recent
            # non-conditioning frames
            pi = 0
            for t in cond_idx:
                in_past = t <= frame_idx if not reverse else t >= frame_idx
                if in_past and pi < core.max_obj_ptrs:
                    ptrs[s, pi] = cond[t]["obj_ptr"][s]
                    tdiff[s, pi] = abs(frame_idx - t)
                    pvalid[s, pi] = True
                    pi += 1
            for t_d in range(1, core.max_obj_ptrs):
                if pi >= core.max_obj_ptrs:
                    break
                if self.use_memory_selection:
                    if t_d >= len(vi):
                        break
                    t = vi[-t_d]
                else:
                    t = frame_idx + t_d if reverse else frame_idx - t_d
                    if t < 0 or t >= state["num_frames"]:
                        break
                out = non_cond.get(t)
                if out is None and t in unsel:
                    out = cond.get(t)
                if out is not None and self._slot_ok(out, s):
                    ptrs[s, pi] = out["obj_ptr"][s]
                    tdiff[s, pi] = t_d
                    pvalid[s, pi] = True
                    pi += 1
        return mem_refs, tpos, valid, ptrs, tdiff, pvalid, src

    def _stack_memory(self, mem_refs):
        core = self.core
        fs = core.feat_size
        mem = torch.zeros((self.obj_slots, core.num_maskmem, fs, fs, core.mem_dim),
                          device=self.device)
        for s, col, out in mem_refs:
            mem[s, col] = out["maskmem"][s]
        return mem

    @staticmethod
    def _lookup_out(state, t):
        out = state["non_cond_frames"].get(t)
        return state["cond_frames"].get(t) if out is None else out

    def _assemble_kv_bank(self, state, src, n_act, tpos, valid):
        """The cached bank for this frame, or None when it does not apply.

        It applies when every active slot selects the same frame for each
        bank column (the common tracking case). The bank is one persistent
        flat array (flatten_kv_bank) in ``state``; per frame only the
        columns whose frame changed are rewritten, in place. Column order
        is arbitrary: a column keeps its frame while that frame stays
        selected, and tpos / valid are permuted to the column order here.

        Returns (k_bank, v_bank, tpos by column, valid by column) or None.
        """
        if n_act == 0:
            return None
        rows = src[:n_act]
        if not (rows == rows[0]).all():
            return None
        desired = [int(t) for t in rows[0]]
        desired_set = {t for t in desired if t >= 0}
        n_mem = len(desired)
        bank = state.get("kv_bank")
        bmap = state.get("kv_bank_frames")
        if bank is None:
            entries = []
            for t in desired:
                if t < 0:
                    entries.append(None)
                    continue
                out = self._lookup_out(state, t)
                if out is None or "mem_kv" not in out:
                    return None
                entries.append(out["mem_kv"])
            if self._kv_zero is None:
                ref = next(e for e in entries if e is not None)
                self._kv_zero = tuple(torch.zeros_like(a) for a in ref)
            bank = flatten_kv_bank([(self._kv_zero if e is None else e)[0] for e in entries],
                                   [(self._kv_zero if e is None else e)[1] for e in entries])
            bmap = list(desired)
        else:
            held = {f: j for j, f in enumerate(bmap) if f in desired_set}
            free = [j for j, f in enumerate(bmap) if f not in desired_set]
            for t in desired:
                if t < 0 or t in held:
                    continue
                out = self._lookup_out(state, t)
                if out is None or "mem_kv" not in out:
                    return None
                k_e, v_e = out["mem_kv"]
                j = free.pop()
                s_e = k_e.shape[2]
                # entry j holds rows [j*S_e, (j+1)*S_e) of the flat bank; the
                # column is written in place (the JAX package's donated
                # dynamic_update_slice), which saves a copy of the ~604 MB
                # bank per frame at full width
                bank[0][:, :, j * s_e:(j + 1) * s_e].copy_(k_e)
                bank[1][:, j * s_e:(j + 1) * s_e].copy_(v_e)
                bmap[j] = t
                held[t] = j
        state["kv_bank"] = bank
        state["kv_bank_frames"] = bmap
        pos_of = {f: i for i, f in enumerate(desired) if f >= 0}
        tpos_c = np.zeros_like(tpos)
        valid_c = np.zeros_like(valid)
        for j in range(n_mem):
            i = pos_of.get(bmap[j])
            if i is not None:
                tpos_c[:, j] = tpos[:, i]
                valid_c[:, j] = valid[:, i]
        return bank[0], bank[1], tpos_c, valid_c

    def _run_track_frame(self, state, frame_idx, reverse=False):
        core = self.core
        tokens, s0, s1 = self._features(state, frame_idx)
        mem_refs, tpos, valid, ptrs, tdiff, pvalid, src = self._gather_memory(
            state, frame_idx, reverse)
        s_n, fs = self.obj_slots, core.feat_size
        # pointer positions are normalised by min(num_frames, max_obj_ptrs) - 1
        max_td = float(min(state["num_frames"], core.max_obj_ptrs))
        n_act = len(state["obj_ids"])
        bank = self._assemble_kv_bank(state, src, n_act, tpos, valid) if self.cache_kv else None
        coords = torch.zeros((s_n, 1, 2), device=self.device)
        labels = -torch.ones((s_n, 1), dtype=torch.long, device=self.device)
        if bank is not None:
            if self._kv_delta is None:
                self._kv_delta = core.tpos_k_delta()
            cond = core.condition_features_cached(
                self._tile(tokens), self._pos, bank[0], bank[1], self._tensor(bank[2]),
                self._tensor(bank[3]), ptrs, self._tensor(tdiff), self._tensor(pvalid),
                self._kv_delta, max_td, shared_ages=True, quantize_bank=self.quantize_bank)
            heads = core.forward_sam_heads(
                cond.reshape(s_n, fs, fs, core.d_model), coords, labels,
                (self._tile(s0), self._tile(s1)), True)
        else:
            heads = self._track(
                self._tile(tokens), self._stack_memory(mem_refs), self._tensor(tpos),
                self._tensor(valid), ptrs, self._tensor(tdiff), self._tensor(pvalid), coords,
                labels, self._tile(s0), self._tile(s1), max_td)
        mem_new = self._encode_mem(self._tile(tokens), heads["high_res_masks"],
                                   heads["object_score_logits"], False)
        score = heads["object_score_logits"][:n_act, 0].float().cpu().numpy()
        ious = heads["ious"][:n_act].float().cpu().numpy()
        # per-frame memory quality: mean over active objects of the
        # rescaled object score times the best IoU
        obj_norm = np.where(score > 0, 1.0 / (1.0 + np.exp(-score)) * 2 - 1, 0.0)
        eff = float((obj_norm * ious.max(-1)).mean()) if n_act else 0.0
        out = {
            "low_res_masks": heads["low_res_masks"],
            "obj_ptr": heads["obj_ptr"],
            "object_score_logits": heads["object_score_logits"],
            "maskmem": mem_new,
            "slot_valid": np.arange(s_n) < n_act,
            "eff_iou_score": eff,
        }
        if self.cache_kv:
            out["mem_kv"] = core.encode_memory_kv(mem_new)
        return out

    def _trim_non_cond(self, state, frame_idx, reverse=False):
        """Drop the spatial memory (and its key cache) of the frame that just
        left the attention window; small per-frame outputs are kept."""
        if not self.trim_past_non_cond_mem:
            return
        sign = -1 if reverse else 1
        past = frame_idx - sign * self.stride * self.core.num_maskmem
        out = state["non_cond_frames"].get(past)
        if out is not None and "maskmem" in out:
            if not self.use_memory_selection or out.get("eff_iou_score", 0.0) < self.mf_threshold:
                del out["maskmem"]
                out.pop("mem_kv", None)
        if self.use_memory_selection:
            # high-score frames outlive the window; far-past ones still go
            far = frame_idx - sign * 20 * self.core.max_obj_ptrs
            out = state["non_cond_frames"].get(far)
            if out is not None and "maskmem" in out:
                del out["maskmem"]
                out.pop("mem_kv", None)

    @torch.inference_mode()
    def propagate_in_video(self, state, start_frame_idx=None, reverse=False):
        """Yield (frame_idx, obj_ids, low-res mask logits) per frame."""
        if not state["cond_frames"]:
            raise ValueError("add prompts before propagating")
        if start_frame_idx is None:
            start_frame_idx = min(state["cond_frames"])
        n_obj = len(state["obj_ids"])
        order = (range(start_frame_idx, -1, -1) if reverse
                 else range(start_frame_idx, state["num_frames"]))
        for t in order:
            if t in state["cond_frames"]:
                out = state["cond_frames"][t]
            else:
                out = self._run_track_frame(state, t, reverse)
                state["non_cond_frames"][t] = out
                self._trim_non_cond(state, t, reverse)
            masks = out["low_res_masks"][:n_obj]
            if self.fill_hole_area > 0 and n_obj:
                # on the host, holes then sprinkles, as the JAX predictor
                # (one copy of the masks off the device and back)
                filled = fill_holes_in_mask_scores_host(
                    masks.float().cpu().numpy(), self.fill_hole_area, remove_sprinkles=True,
                    native=self.device.type == "cuda")
                masks = torch.from_numpy(filled).to(masks.device)
            yield t, list(state["obj_ids"]), masks

    @torch.inference_mode()
    def remove_object(self, state, obj_id):
        """Drop an object slot: all slot-aligned state shifts down, the
        per-frame outputs and the prompt arrays alike."""
        if obj_id not in state["obj_ids"]:
            return
        slot = state["obj_ids"].index(obj_id)
        state["obj_ids"].remove(obj_id)

        def shift(arr, fill=0):
            arr[slot:-1] = arr[slot + 1:].copy() if isinstance(arr, np.ndarray) \
                else arr[slot + 1:].clone()
            arr[-1] = fill

        for frames in (state["cond_frames"], state["non_cond_frames"]):
            for out in frames.values():
                for k in _SLOT_KEYS:
                    if k in out:
                        shift(out[k], False if k == "slot_valid" else 0)
                # the slot-aligned key caches are stale after the shift: drop
                # them (tracking takes the plain path until frames re-encode)
                out.pop("mem_kv", None)
        # so is the persistent bank built from them (the JAX predictor keeps
        # it, and would reuse its stale columns)
        state.pop("kv_bank", None)
        state.pop("kv_bank_frames", None)
        for coords, labs in state["prompts"].values():
            shift(coords)
            shift(labs, -1)
        for t in [t for t, o in state["cond_frames"].items() if not o["slot_valid"].any()]:
            del state["cond_frames"][t]
            state["prompts"].pop(t, None)
