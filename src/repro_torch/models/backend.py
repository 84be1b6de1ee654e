"""The attention backend layer: ONE registry-dispatched execution site
for every attention implementation of the port.

Model code (``model._self_attention``) never inspects ``attn_impl``: it
builds the merged KV view and calls :func:`attend`; the string names a
backend in :data:`BACKENDS` and that is the only dispatch in the port.

Dispatch contract
-----------------
Every backend is a callable

    ``fn(ctx, window, packed, q, k_all, v_all, kv_pos)
        -> (out, row_mass, key_mass)``

with ``q [B,Tq,H,D]``, ``k_all/v_all [B,S,Hkv,D]`` the *merged* KV
(cached slots + freshly scattered tokens), ``kv_pos [B,S]`` per-slot
absolute positions (-1 = dead slot), and ``ctx`` the model's ``Ctx``
(read-only). Two serving-side invariants gate every backend alike:

* **per-request segment masks**: when ``packed`` (``ctx.seg_ids`` /
  ``ctx.kv_seg`` present) attention stays within same-segment keys;
  the optional ``ctx.pack_qidx``/``pack_kidx`` gather maps switch the
  dense path to block-diagonal per-request attention without changing
  the numbers.
* **decode slots**: decode queries carry position -1 on masked batch
  rows (no live request); every backend yields inert (zero) rows there,
  so incremental decode joins/leaves cannot perturb live rows.

``row_mass [B,Tq,C]`` / ``key_mass [B,S]`` are the Cache-Craft attention
statistics (None when not collected; the kernel path never produces
key-side mass, and the executor's capture then falls back to inter-only
scoring).

Backends
--------
``dense``         position-mask + softmax oracle (block-diagonal when
                  gather maps exist). The reference all others are held
                  against.
``kernel``        the hand-written CUDA kernels:
                  ``kernels/chunk_attention`` for prefill/partial windows
                  (fused mass statistic, segment mask in-kernel) and
                  ``kernels/decode_attention`` for one-token decode.
``paged``         block-table-native decode through one gather (below).
``paged_kernel``  the CUDA paged-decode kernel over the same contract
                  (allclose, not bitwise: its online softmax reduces in
                  block order).
``flash``         blocked online-softmax loop (``layers.gqa_attend_flash``;
                  ``flash_skip``: the balanced causal schedule). Both
                  fall back to the dense oracle under ``collect_stats``
                  or packing (no mass statistic, no segment mask), as
                  the reference does.
``auto``          dense for small / stat-collecting / packed shapes,
                  flash beyond 2^21 score elements (the reference's
                  rule).
``sharded``       tensor-parallel dense: the oracle once per head shard of
                  the serving mesh (``set_serving_mesh``; below). Without
                  a mesh it is ``dense``, as in the reference.
``flash_cp``      ``flash`` with the query rows split over the
                  context-parallel mesh (``set_cp_mesh``,
                  ``layers.gqa_attend_flash_cp``); ``flash`` without one,
                  dense under ``collect_stats`` or packing.

Paged attend contract
---------------------
The ``paged`` backends read KV **in place from the pool's block
storage**. The decode cache leaf is the pool twin ``{"kp": [NBf, Hkv,
D], "vp": [NBf, Hkv, D], "ppos": [NBf]}`` (``NBf = num_blocks *
block_size`` flat arena slots shared by every request); the
per-request view arrives through ``ctx``:

* ``ctx.paged_rows [B, S]``: compact pool-flat slot-index rows
  (``KVPool.table_slot_index``), -1 pads.
* ``ctx.paged_block_rows [B, NBmax]`` / ``ctx.paged_block_size``: the
  raw block-id rows and block size for the paged kernel, which walks
  pool blocks directly (no gather at all; per-slot ``ppos`` masking
  handles interior padding).
* ``k_all / v_all / kv_pos`` are the pool twin leaves themselves (3-d /
  1-d) with the new token's KV already written at ``ctx.decode_slot``.

``paged`` dereferences the slot rows with a device-side gather and
hands the result to the dense (or, with a serving mesh, the
``sharded``) oracle: the gathered operand reproduces
``pool.gather(compact=True)`` element for element, so logits stay
bit-identical to the arena path. ``paged_kernel`` skips even that
gather: the kernel reads ``[NB, bs, Hkv, D]``, a *view* of the flat
twin, never a copy; under a serving mesh it launches once per shard on
that shard's head slice ``[NB, bs, Hkv/n, D]``, a strided view the
kernel reads in place.

Head-shard layout (the serving mesh)
------------------------------------
``sharded`` splits q/k/v over the head axis of a ``("heads",)`` mesh
(``launch.mesh.make_serving_mesh``) installed with
:func:`set_serving_mesh`, and runs the dense helpers once per shard
through the one-process ``distributed.collectives.shard_map``; the
engine's KVPool mirrors the split (``kv_shards``):

* ``num_heads % n == 0`` and ``num_kv_heads % n == 0``: contiguous head
  blocks keep the GQA q-head -> kv-head grouping shard-local, so each
  head's arithmetic is the unsharded oracle's.
* the attention output is all-gathered (data movement only) before the
  ``wo`` projection; only the head-summed mass statistics cross shards,
  summed in shard order (``psum``), so they are allclose, not bitwise,
  to the unsharded sums.
* block bookkeeping stays shard-agnostic: a block is allocated on every
  shard or none (``serving/kvpool.py``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import all_gather, psum, shard_map
from repro_torch.distributed.sharding import P
from repro_torch.models import layers as L

# ---------------------------------------------------------------------------
# Module-level mesh state (installed by launch / serving code)
# ---------------------------------------------------------------------------
_CP_MESH = None
_SERVING_MESH = None
_SERVING_AXIS = "heads"


def set_cp_mesh(mesh):
    """Install the mesh of context-parallel attention (``flash_cp``, over
    its "model" axis); None uninstalls."""
    global _CP_MESH
    _CP_MESH = mesh


def set_serving_mesh(mesh, axis: str = "heads"):
    """Install the tensor-parallel serving mesh of the ``sharded`` backend
    and of ``paged`` / ``paged_kernel`` under it (None uninstalls)."""
    global _SERVING_MESH, _SERVING_AXIS
    _SERVING_MESH = mesh
    _SERVING_AXIS = axis


def serving_mesh():
    return _SERVING_MESH


def _check_head_split(what: str, mesh, H: int, Hkv: int):
    """The serving axis size must divide both head counts."""
    n = mesh.shape[_SERVING_AXIS]
    if H % n or Hkv % n:
        raise ValueError(
            f"{what} needs num_heads ({H}) and num_kv_heads ({Hkv}) "
            f"divisible by the '{_SERVING_AXIS}' mesh axis ({n}) so head "
            "blocks keep the GQA grouping shard-local")


# ---------------------------------------------------------------------------
# Pure tensor helpers
# ---------------------------------------------------------------------------
def _dense_full(cfg, window, q, k_all, v_all, kv_pos, positions,
                q_seg, k_seg, k_chunk):
    mask = L.position_mask(positions, kv_pos, window,
                           q_seg=q_seg, k_seg=k_seg)
    return L.gqa_attend_dense(q, k_all, v_all, mask, k_chunk=k_chunk,
                              num_chunks=cfg.stats_chunks)


def _block_diagonal(cfg, window, q, k_all, v_all, kv_pos, positions,
                    k_chunk, qidx, kidx):
    """Packed-prefill attention without the cross-request quadratic
    waste: gather each request's query rows [R, Amax] and KV slice
    [R, Smax] (indices from the executor, -1 = padding), run batched
    dense attention per request, and scatter results back to the packed
    row order through a dump slot (the reference's ``mode="drop"``)."""
    A = q.shape[1]
    S = k_all.shape[1]
    qsafe = qidx.clamp(0, A - 1)
    ksafe = kidx.clamp(0, S - 1)
    qr = q[0][qsafe]                                    # [R, Amax, H, D]
    kr = k_all[0][ksafe]                                # [R, Smax, Hkv, D]
    vr = v_all[0][ksafe]
    neg = torch.full((), -1, dtype=positions.dtype, device=q.device)
    qpos_r = torch.where(qidx >= 0, positions[0][qsafe], neg)
    kpos_r = torch.where(kidx >= 0, kv_pos[0][ksafe], neg)
    mask = L.position_mask(qpos_r, kpos_r, window)
    k_chunk_r = None
    if k_chunk is not None:
        k_chunk_r = torch.where(kidx >= 0, k_chunk[0][ksafe],
                                torch.full_like(k_chunk[0][ksafe],
                                                cfg.stats_chunks - 1))
    out_r, row_mass_r, key_mass_r = L.gqa_attend_dense(
        qr, kr, vr, mask, k_chunk=k_chunk_r, num_chunks=cfg.stats_chunks)
    # each live row / slot appears exactly once; padding lands in the dump
    # slot (index A or S) that is sliced away
    qflat = torch.where(qidx >= 0, qidx, A).reshape(-1)
    H, D = out_r.shape[-2:]
    out = out_r.new_zeros((A + 1, H, D))
    out[qflat] = out_r.reshape(-1, H, D)
    out = out[:A][None]
    row_mass = key_mass = None
    if row_mass_r is not None:
        C = row_mass_r.shape[-1]
        row_mass = row_mass_r.new_zeros((A + 1, C))
        row_mass[qflat] = row_mass_r.reshape(-1, C)
        row_mass = row_mass[:A][None]
    if key_mass_r is not None:
        kflat = torch.where(kidx >= 0, kidx, S).reshape(-1)
        key_mass = key_mass_r.new_zeros((S + 1,))
        key_mass[kflat] = key_mass_r.reshape(-1)
        key_mass = key_mass[:S][None]
    return out, row_mass, key_mass


# ---------------------------------------------------------------------------
# Backend implementations
# ---------------------------------------------------------------------------
def _impl_dense(ctx, window, packed, q, k_all, v_all, kv_pos):
    cfg = ctx.cfg
    k_chunk = ctx.chunk_ids if ctx.collect_stats else None
    if packed and ctx.pack_qidx is not None and ctx.pack_kidx is not None:
        return _block_diagonal(cfg, window, q, k_all, v_all, kv_pos,
                               ctx.positions, k_chunk,
                               ctx.pack_qidx, ctx.pack_kidx)
    return _dense_full(cfg, window, q, k_all, v_all, kv_pos, ctx.positions,
                       ctx.seg_ids if packed else None,
                       ctx.kv_seg if packed else None, k_chunk)


def _flash(ctx, window, packed, q, k_all, v_all, kv_pos, causal_skip=False):
    if ctx.collect_stats or packed:
        # flash has no mass statistic / segment mask: stats collection
        # and packed rows fall back to the dense oracle
        return _impl_dense(ctx, window, packed, q, k_all, v_all, kv_pos)
    out = L.gqa_attend_flash(q, k_all, v_all, ctx.positions, kv_pos,
                             window, causal_skip=causal_skip)
    return out, None, None


def _impl_flash(ctx, window, packed, q, k_all, v_all, kv_pos):
    return _flash(ctx, window, packed, q, k_all, v_all, kv_pos)


def _impl_flash_skip(ctx, window, packed, q, k_all, v_all, kv_pos):
    return _flash(ctx, window, packed, q, k_all, v_all, kv_pos,
                  causal_skip=True)


def _impl_flash_cp(ctx, window, packed, q, k_all, v_all, kv_pos):
    if ctx.collect_stats or packed:
        return _impl_dense(ctx, window, packed, q, k_all, v_all, kv_pos)
    if _CP_MESH is None:
        return _flash(ctx, window, packed, q, k_all, v_all, kv_pos)
    out = L.gqa_attend_flash_cp(q, k_all, v_all, ctx.positions, kv_pos,
                                _CP_MESH, window)
    return out, None, None


def _impl_auto(ctx, window, packed, q, k_all, v_all, kv_pos):
    if ctx.collect_stats or packed or \
            q.shape[1] * k_all.shape[1] <= (1 << 21):
        return _impl_dense(ctx, window, packed, q, k_all, v_all, kv_pos)
    return _flash(ctx, window, packed, q, k_all, v_all, kv_pos)


def _impl_sharded(ctx, window, packed, q, k_all, v_all, kv_pos):
    mesh = _SERVING_MESH
    if mesh is None:
        # one device: the same numbers, no mesh required
        return _impl_dense(ctx, window, packed, q, k_all, v_all, kv_pos)
    cfg = ctx.cfg
    ax = _SERVING_AXIS
    _check_head_split("sharded backend", mesh, q.shape[2], k_all.shape[2])
    has_stats = ctx.collect_stats and ctx.chunk_ids is not None
    k_chunk = ctx.chunk_ids if has_stats else None
    if packed and ctx.pack_qidx is not None and ctx.pack_kidx is not None:
        def body(qs, ks, vs, pos, kvp, cid, qi, ki):
            return _block_diagonal(cfg, window, qs, ks, vs, kvp, pos, cid,
                                   qi, ki)
        operands = (q, k_all, v_all, ctx.positions, kv_pos, k_chunk,
                    ctx.pack_qidx, ctx.pack_kidx)
    else:
        def body(qs, ks, vs, pos, kvp, sq, sk, cid):
            return _dense_full(cfg, window, qs, ks, vs, kvp, pos, sq, sk,
                               cid)
        operands = (q, k_all, v_all, ctx.positions, kv_pos,
                    ctx.seg_ids if packed else None,
                    ctx.kv_seg if packed else None, k_chunk)
    shard4 = P(None, None, ax, None)
    parts = shard_map(body, mesh=mesh, in_specs=(shard4,) * 3 + (P(),) * 5,
                      axis=ax)(*operands)
    # the all-gather moves data only: each head's output keeps the
    # unsharded oracle's bits; the head-summed mass is summed over shards
    out = all_gather([o for o, _, _ in parts], dim=2)
    if not has_stats:
        return out, None, None
    return out, psum([r for _, r, _ in parts]), psum([k for _, _, k in parts])


def _impl_kernel(ctx, window, packed, q, k_all, v_all, kv_pos):
    # q and K/V go to the kernels in their own dtypes: a bf16 model over
    # fp32 caches hands bf16 q with fp32 K/V (the kernels' mixed
    # instantiation, output in q's dtype), as the reference does
    cfg = ctx.cfg
    if ctx.mode == "decode" and q.shape[1] == 1 and not ctx.collect_stats:
        # one-token step: the decode kernel (masked batch rows with
        # q_pos = -1 yield zeros)
        from repro_torch.kernels.decode_attention.ops import \
            decode_attention
        out = decode_attention(q[:, 0], k_all, v_all, ctx.positions[:, 0],
                               kv_pos, window=window)
        return out[:, None], None, None
    # chunk-attention kernel: fused mass statistic, per-request segment
    # mask threaded into the kernel
    from repro_torch.kernels.chunk_attention.ops import chunk_attention
    k_chunk = ctx.chunk_ids if ctx.chunk_ids is not None \
        else torch.zeros_like(kv_pos)
    out, row_mass = chunk_attention(
        q, k_all, v_all, ctx.positions, kv_pos, k_chunk,
        q_seg=ctx.seg_ids, k_seg=ctx.kv_seg,
        num_chunks=cfg.stats_chunks, window=window)
    if not ctx.collect_stats:
        row_mass = None
    # the fused kernel does not expose key-side received mass; the
    # executor's capture falls back to inter-only scoring
    return out, row_mass, None


def _impl_paged(ctx, window, packed, q, k_all, v_all, kv_pos):
    """Block-table-native decode, exact route: dereference the compact
    slot-index rows with one device-side gather and hand the result to
    the dense oracle (bit-identical to the arena path)."""
    if ctx.paged_rows is None or k_all.dim() != 3:
        # not a pool-twin cache (unit tests driving the backend with
        # dense operands): the dense oracle is the fallback
        return _impl_dense(ctx, window, packed, q, k_all, v_all, kv_pos)
    rows = ctx.paged_rows                                   # [B, S]
    valid = rows >= 0
    safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
    zero = torch.zeros((), dtype=k_all.dtype, device=k_all.device)
    kg = torch.where(valid[..., None, None], k_all[safe], zero)
    vg = torch.where(valid[..., None, None], v_all[safe], zero)
    kvp = torch.where(valid, kv_pos[safe], torch.full_like(kv_pos[safe], -1))
    if _SERVING_MESH is not None:
        return _impl_sharded(ctx, window, packed, q, kg, vg, kvp)
    return _impl_dense(ctx, window, packed, q, kg, vg, kvp)


def _impl_paged_kernel(ctx, window, packed, q, k_all, v_all, kv_pos):
    """Block-table-native decode, kernel route: the kernel walks each
    request's block-id row and reads K/V straight out of the pool twin
    (no gather of any kind); under a serving mesh, one launch per shard
    on its head slice of the twin, outputs all-gathered."""
    if (ctx.paged_block_rows is None or not ctx.paged_block_size
            or k_all.dim() != 3 or ctx.collect_stats):
        return _impl_paged(ctx, window, packed, q, k_all, v_all, kv_pos)
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    bs = ctx.paged_block_size
    NBf = k_all.shape[0]
    # views of the flat twin, never copies
    kb = k_all.view(NBf // bs, bs, *k_all.shape[1:])
    vb = v_all.view(NBf // bs, bs, *v_all.shape[1:])
    pb = kv_pos.view(NBf // bs, bs)
    qd, rows, qpos = q[:, 0], ctx.paged_block_rows, ctx.positions[:, 0]
    mesh = _SERVING_MESH
    if mesh is None:
        out = paged_decode_attention(qd, kb, vb, pb, rows, qpos,
                                     window=window)
        return out[:, None], None, None
    ax = _SERVING_AXIS
    _check_head_split("paged_kernel", mesh, qd.shape[1], kb.shape[2])

    def body(qs, ks, vs, ps, rs, qps):
        # ks / vs: this shard's head slice of the twin, read in place; the
        # query slice is copied (it is B x H/n x D)
        return paged_decode_attention(qs.contiguous(), ks, vs, ps, rs, qps,
                                      window=window)

    shard_kv = P(None, None, ax, None)
    parts = shard_map(body, mesh=mesh,
                      in_specs=(P(None, ax, None), shard_kv, shard_kv,
                                P(), P(), P()),
                      axis=ax)(qd, kb, vb, pb, rows, qpos)
    return all_gather(parts, dim=1)[:, None], None, None


BACKENDS = {
    "auto": _impl_auto,
    "dense": _impl_dense,
    "kernel": _impl_kernel,
    "sharded": _impl_sharded,
    "flash": _impl_flash,
    "flash_skip": _impl_flash_skip,
    "flash_cp": _impl_flash_cp,
    "paged": _impl_paged,
    "paged_kernel": _impl_paged_kernel,
}


def attend(ctx, kind: str, q, k_all, v_all, kv_pos):
    """THE attention dispatch site. ``kind`` is the layer kind ("attn" |
    "local"; only "local" applies ``cfg.window``); everything else
    follows the contract above."""
    try:
        impl = BACKENDS[ctx.attn_impl]
    except KeyError:
        raise ValueError(
            f"unknown attn_impl {ctx.attn_impl!r}; known: "
            f"{sorted(BACKENDS)}") from None
    window = ctx.cfg.window if kind == "local" else 0
    packed = ctx.seg_ids is not None and ctx.kv_seg is not None
    return impl(ctx, window, packed, q, k_all, v_all, kv_pos)
