"""Paged KV block manager (PagedAttention-style, 16-token blocks).

The pool owns [L, num_blocks, block, Hkv, D] K/V arenas plus a free list
and per-block refcounts. Chunk-cache injections can share blocks across
requests (copy-on-write on the recompute path). The decode path gathers
a request's block table into a dense view when the request joins the
decode batch.

Reservation protocol (reserve-at-admission)
-------------------------------------------
Admission control used to key off ``free_blocks`` alone, which races the
decode path: a request admitted under momentary headroom could burn its
share of the packed prefill pass and then fail ``write_prefill`` when
decode appends consumed the blocks in between. The pool therefore
exposes a three-phase protocol:

* ``reserve(n) -> Reservation`` atomically moves ``n`` blocks out of the
  free list into the reservation (refcount stays 0, blocks excluded from
  ``free_blocks``/``free_tokens``).
* ``write_prefill``/``append_token`` draw blocks from the request's
  reservation first and only fall back to the free list (e.g. for a
  copy-on-write split of a block shared beyond the reservation's
  estimate).
* ``commit(res)`` (request reached a terminal success state) and
  ``cancel(res)`` (requeue/expiry/failure) return the undrawn remainder
  to the free list and close the reservation.

Accounting is CoW-aware: a block is *live* once (``refs > 0``) no matter
how many tables share it, so shared chunk-cache blocks count once and
the conservation law

    ``free_blocks + live_blocks + reserved_blocks == num_blocks``

holds after every operation (machine-checked by
``tests/test_kvpool_properties.py``).

Zero-copy chunk sharing (pin/unpin lifecycle)
---------------------------------------------
Chunk-cache hits are injected as *shared block runs* instead of being
copied into each request's private blocks. The lifecycle:

* **pin** — the chunk store materializes one canonical, block-aligned
  run per (variant, layout-start) pair: ``alloc`` + ``write_run``. The
  store holds the run's owning reference (``refs == 1``) for as long as
  the variant stays pool-resident.
* **share** — each request's table references the run via
  ``append_shared`` (``refs += 1`` per reader, blocks appear in the
  table's block list; the table always starts shared runs and fresh
  segments on a block boundary, padding slots carry ``pos == -1`` so
  attention masks them and numerics stay bit-identical to the copy
  path).
* **CoW** — a write that would mutate a block visible to other readers
  (``refs > 1``) — the recompute-fixup rows of a hit chunk
  (``write_rows``) or a decode append into a shared tail
  (``append_token``) — first clones the block into the writer's table,
  so no reader ever observes another request's writes.
* **unpin** — when the variant is evicted from the chunk store the
  owning reference is dropped — immediately at zero readers, deferred
  to the last reader's ``free_table``/run-release otherwise
  (``PoolResidency`` in ``core.chunkstore`` tracks readers and the
  ``evict_pending`` flag). Under admission pressure the engine also
  *reclaims* cold runs (zero readers) oldest-first, so pinned blocks
  never starve the queue — the variants stay cached in the tiers and
  re-materialize on the next hit.

Delta-only reservation protocol
-------------------------------
With sharing on, admission reserves only the *delta* blocks — the
segments the request cannot share: miss chunks, the question tail and
decode headroom. Resident shared runs cost the admitting request zero
new blocks (the owner already holds them), so
``Scheduler.next_prefills`` (via the engine's block estimator) packs
strictly more requests per iteration under pool pressure while the
conservation law keeps holding: a CoW clone that exceeds the delta
estimate simply falls back from the reservation to the free list.

Head-sharded block layout (``kv_shards``)
-----------------------------------------
Tensor-parallel serving (the ``sharded`` attention backend) splits the
KV head axis over the mesh: shard ``s`` owns heads
``[s*Hkv/n, (s+1)*Hkv/n)`` of *every* block. The arenas keep the head
axis innermost-contiguous, so ``shard_view(s)`` returns zero-copy
per-shard arenas ``[L, num_blocks, block, Hkv/n, D]`` — the bytes each
device holds — while every IO method keeps writing through the full
logical arena unchanged. The invariants:

* block ids are **global**: a block exists on every shard or on none,
  so the free list, refcounts, reservations and CoW run shard-agnostic
  and the conservation law ``free + live + reserved == num_blocks``
  holds per shard by construction;
* chunkstore residency, zero-copy shared runs and preemption reclaim
  therefore work unchanged — sharding only divides the *bytes per
  device* (``block_nbytes / kv_shards``), never the block bookkeeping;
* ``kv_heads % kv_shards == 0`` (contiguous head blocks keep the GQA
  grouping shard-local; enforced at construction).

Paged decode (``block_view`` / ``table_slot_index`` / dirty log)
----------------------------------------------------------------
The paged decode path reads K/V **in place** from the block arenas —
no per-request gather, no dense row-arena copy. The pool exports:

* ``block_view()`` — the raw ``(k, v, pos)`` arenas, zero-copy. Every
  pool write (prefill, recompute fixups, CoW clones, decode appends)
  is visible through this view the moment it lands; consumers must not
  cache a stale copy across pool mutations.
* ``table_slot_index(table, pad_to)`` — a request's *compact* pool-flat
  slot-index row: entry ``i`` is the flat arena slot
  (``block_id * block_size + offset``) holding the token at logical
  position ``i``; -1 pads. Indexing the flattened arenas with this row
  reproduces ``gather(..., compact=True)``'s exact operand layout, so
  paged attention stays bit-identical to the arena path.
* ``table_block_row(table, pad_to)`` — the block-id row (-1 padded)
  the paged Pallas kernel's scalar-prefetched index maps consume.
* ``ensure_append_slot(table, reservation)`` — pre-opens the next
  decode-append slot (allocating / CoW-cloning its block *before* the
  jitted step) so the attention pass can scatter the new token's KV
  straight into the pool view at a statically-known flat slot.
* ``dirty_blocks()`` / ``clear_dirty(ids)`` — a write log for keeping
  a device-side twin of the arenas coherent: every mutating op records
  the block ids it touched; a consumer uploads exactly those blocks
  and clears them.

**Aliasing / CoW invariant** (what makes in-place reads safe): a block
visible to more than one holder is NEVER mutated in place. Every write
path routes through ``_cow_block``, which clones the block into the
writer's table and *swaps the table's index entry* —
``table.blocks[bi] = new_block`` — leaving the shared block's bytes
untouched. Readers holding the old block id (other tables, canonical
runs, an exported block-index row) therefore keep seeing the exact
bytes they referenced; writers see their private clone only after
re-exporting their index row. Mutating a shared block in place would
corrupt every other reader's in-place view — the property suite drives
random op interleavings against this invariant.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.metrics import ServingCounters


@dataclass
class BlockTable:
    blocks: List[int] = field(default_factory=list)
    length: int = 0                      # tokens used


@dataclass
class Reservation:
    """Blocks set aside for one request at admission time.

    ``blocks`` hold ids popped from the free list (refcount 0); they are
    handed to the request's table one by one as ``write_prefill`` /
    ``append_token`` need them. ``commit``/``cancel`` return whatever was
    not drawn."""
    blocks: List[int] = field(default_factory=list)
    drawn: int = 0                       # blocks moved into a table
    closed: bool = False

    @property
    def remaining(self) -> int:
        return len(self.blocks)


class KVPool:
    def __init__(self, num_layers: int, kv_heads: int, head_dim: int,
                 num_blocks: int, block_size: int = 16,
                 dtype=np.float32,
                 counters: Optional[ServingCounters] = None,
                 kv_shards: int = 1):
        if kv_shards < 1 or kv_heads % kv_shards:
            raise ValueError(
                f"kv_heads ({kv_heads}) must be divisible by kv_shards "
                f"({kv_shards}) — contiguous head blocks per shard")
        self.L = num_layers
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.kv_shards = kv_shards
        self.heads_per_shard = kv_heads // kv_shards
        self.k = np.zeros((num_layers, num_blocks, block_size, kv_heads,
                           head_dim), dtype)
        self.v = np.zeros_like(self.k)
        self.pos = np.full((num_blocks, block_size), -1, np.int32)
        self.refs = np.zeros(num_blocks, np.int32)
        self.free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._reserved = 0               # blocks inside open reservations
        # incremental mirrors of (refs > 0).sum() / (refs > 1).sum() so
        # the hot alloc/share/release paths never scan the whole pool
        self._live = 0
        self._shared = 0
        # write log for device-twin coherence (paged decode): block ids
        # whose host bytes changed since the last clear_dirty
        self._dirty: set = set()
        self.counters = counters if counters is not None \
            else ServingCounters()

    @property
    def free_blocks(self) -> int:
        return len(self.free)

    @property
    def block_nbytes(self) -> int:
        """KV bytes held by one block (k + v arenas) — the size feed
        for eviction-policy candidates over pool-resident runs (the
        shared ``core.eviction`` contract: score = reuse x cost /
        size)."""
        return int(self.k[:, 0].nbytes + self.v[:, 0].nbytes)

    @property
    def shard_block_nbytes(self) -> int:
        """KV bytes ONE shard (device) holds per block — the
        tensor-parallel per-device memory metric."""
        return self.block_nbytes // self.kv_shards

    def shard_view(self, shard: int):
        """Zero-copy per-shard arenas ``(k, v) [L, num_blocks, block,
        Hkv/n, D]``: the bytes device ``shard`` owns. Views write
        through to the logical arena, so IO through either side stays
        coherent — the single-host emulation of per-device HBM."""
        if not 0 <= shard < self.kv_shards:
            raise IndexError(shard)
        h0 = shard * self.heads_per_shard
        h1 = h0 + self.heads_per_shard
        return self.k[..., h0:h1, :], self.v[..., h0:h1, :]

    def peak_kv_bytes_per_device(self) -> int:
        """Peak live KV bytes per device over the pool's lifetime."""
        return self.counters.live_blocks_peak * self.shard_block_nbytes

    @property
    def free_tokens(self) -> int:
        """Token capacity of the free list (admission-control headroom:
        tokens, not blocks, is the scheduler's currency). Reserved
        blocks are already excluded — they left the free list at
        ``reserve`` time."""
        return len(self.free) * self.block_size

    @property
    def reserved_blocks(self) -> int:
        """Blocks held by open reservations (refcount 0, not free)."""
        return self._reserved

    @property
    def live_blocks(self) -> int:
        """Blocks referenced by at least one table — shared (CoW) blocks
        count once, which is what makes the conservation law hold
        (incrementally maintained; the property suite machine-checks it
        against the free list)."""
        return self._live

    @property
    def shared_blocks(self) -> int:
        """Blocks currently referenced by more than one holder (a
        canonical run's owner counts as one holder)."""
        return self._shared

    def _note_usage(self):
        self.counters.live_blocks_peak = max(
            self.counters.live_blocks_peak, self._live)
        self.counters.shared_blocks_peak = max(
            self.counters.shared_blocks_peak, self._shared)

    def blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    # ---- reservations ------------------------------------------------------
    def reserve(self, n: int) -> Optional[Reservation]:
        """Move ``n`` blocks from the free list into a reservation, or
        return None (and count a failure) when headroom is short."""
        if n > len(self.free):
            self.counters.reserve_failures += 1
            return None
        res = Reservation(blocks=[self.free.pop() for _ in range(n)])
        self._reserved += n
        self.counters.reservations_made += 1
        self.counters.blocks_reserved_total += n
        self.counters.blocks_reserved_peak = max(
            self.counters.blocks_reserved_peak, self._reserved)
        return res

    def commit(self, res: Optional[Reservation]):
        """Close a reservation after terminal success; undrawn blocks
        return to the free list."""
        if self._close(res):
            self.counters.reservations_committed += 1

    def cancel(self, res: Optional[Reservation]):
        """Close a reservation on requeue/expiry/failure paths."""
        if self._close(res):
            self.counters.reservations_cancelled += 1

    def _close(self, res: Optional[Reservation]) -> bool:
        if res is None or res.closed:
            return False
        for b in res.blocks:
            self._reserved -= 1
            self.free.append(b)
        res.blocks = []
        res.closed = True
        return True

    def _take(self, res: Optional[Reservation]) -> Optional[int]:
        """Draw one block out of a reservation (refcount 0 -> 1)."""
        if res is None or res.closed or not res.blocks:
            return None
        b = res.blocks.pop()
        self._reserved -= 1
        res.drawn += 1
        self.refs[b] = 1
        self._live += 1
        return b

    # ---- allocation --------------------------------------------------------
    def alloc(self, n: int,
              reservation: Optional[Reservation] = None) -> Optional[List[int]]:
        """Allocate ``n`` blocks, drawing from ``reservation`` first and
        falling back to the free list; all-or-nothing."""
        out: List[int] = []
        while len(out) < n:
            b = self._take(reservation)
            if b is None:
                break
            out.append(b)
        short = n - len(out)
        if short > len(self.free):
            # roll back reservation draws so accounting stays exact
            if reservation is not None:
                for b in reversed(out):
                    self.refs[b] = 0
                    self._live -= 1
                    reservation.blocks.append(b)
                    reservation.drawn -= 1
                    self._reserved += 1
            return None
        for _ in range(short):
            b = self.free.pop()
            self.refs[b] = 1
            self._live += 1
            out.append(b)
        self._note_usage()
        return out

    def share(self, blocks: List[int]):
        for b in blocks:
            self.refs[b] += 1
            if self.refs[b] == 1:
                self._live += 1
            elif self.refs[b] == 2:
                self._shared += 1
        self._note_usage()

    def release(self, blocks: List[int]):
        for b in blocks:
            self.refs[b] -= 1
            if self.refs[b] == 0:
                self._live -= 1
                self.pos[b] = -1
                self.free.append(b)
            elif self.refs[b] == 1:
                self._shared -= 1

    # ---- IO ----------------------------------------------------------------
    def write_prefill(self, table: BlockTable, k_layers: np.ndarray,
                      v_layers: np.ndarray, pos: np.ndarray,
                      reservation: Optional[Reservation] = None) -> bool:
        """Copy [L,S,...] prefill KV into the table's blocks (allocating
        from the request's reservation when one is supplied)."""
        S = k_layers.shape[1]
        need = self.blocks_needed(S)
        extra = need - len(table.blocks)
        if extra > 0:
            got = self.alloc(extra, reservation)
            if got is None:
                return False
            table.blocks.extend(got)
        self.write_run(table.blocks[:need], k_layers, v_layers, pos)
        table.length = S
        return True

    def write_run(self, blocks: List[int], k_layers: np.ndarray,
                  v_layers: np.ndarray, pos: np.ndarray):
        """Write [L,S,...] KV into a pre-allocated block run (the
        canonical pool-resident copy of a chunk-cache variant). Padding
        slots of the tail block are zeroed with ``pos == -1`` so every
        reader sees deterministic, attention-inert padding."""
        S = k_layers.shape[1]
        bs = self.block_size
        assert len(blocks) == self.blocks_needed(S)
        self._dirty.update(blocks)
        for i, b in enumerate(blocks):
            s0, s1 = i * bs, min(S, (i + 1) * bs)
            self.k[:, b, :s1 - s0] = k_layers[:, s0:s1]
            self.v[:, b, :s1 - s0] = v_layers[:, s0:s1]
            self.pos[b, :s1 - s0] = pos[s0:s1]
            if s1 - s0 < bs:
                self.k[:, b, s1 - s0:] = 0.0
                self.v[:, b, s1 - s0:] = 0.0
                self.pos[b, s1 - s0:] = -1

    def append_shared(self, table: BlockTable, blocks: List[int]) -> int:
        """Zero-copy: reference a canonical run's blocks from this
        table (``refs += 1`` per block, nothing copied). The run starts
        on the next block boundary (``len(table.blocks)`` whole blocks);
        padding slots before and inside it carry ``pos == -1`` and are
        masked by attention. Returns the table-slot index where the
        run's first token landed."""
        assert table.length <= len(table.blocks) * self.block_size
        base = len(table.blocks)
        self.share(blocks)
        table.blocks.extend(blocks)
        table.length = (base + len(blocks)) * self.block_size
        self.counters.shared_block_refs += len(blocks)
        return base * self.block_size

    def append_segment(self, table: BlockTable, k_layers: np.ndarray,
                       v_layers: np.ndarray, pos: np.ndarray,
                       reservation: Optional[Reservation] = None
                       ) -> Optional[int]:
        """Append a fresh (private) block-aligned segment of S tokens at
        the table tail, drawing blocks from ``reservation`` first.
        Returns the segment's first table-slot index, or None when the
        pool cannot supply the blocks. The final segment of a prefill
        leaves ``table.length`` at its exact token end so decode appends
        continue in the same block."""
        S = k_layers.shape[1]
        need = self.blocks_needed(S)
        got = self.alloc(need, reservation)
        if got is None:
            return None
        base = len(table.blocks)
        table.blocks.extend(got)
        self.write_run(got, k_layers, v_layers, pos)
        table.length = base * self.block_size + S
        return base * self.block_size

    def _zero_block(self, b: int):
        """Scrub a freshly-allocated decode-tail block: a reused block
        keeps the previous tenant's KV bytes in its not-yet-appended
        slots, which ``gather`` (non-compact) would expose as padding
        whose contents depend on allocation history. Zeroed, the dead
        slots are deterministic — the arena and paged decode paths
        produce byte-identical final pool KV even though they allocate
        and CoW at slightly different times. (``write_run`` zeroes its
        own tail padding; CoW clones copy already-clean bytes.)"""
        self.k[:, b] = 0.0
        self.v[:, b] = 0.0
        self.pos[b] = -1

    def _cow_block(self, table: BlockTable, bi: int,
                   reservation: Optional[Reservation] = None
                   ) -> Optional[int]:
        """Clone table block ``bi`` if other holders still reference it
        (copy-on-write); returns the (possibly new) block id."""
        b = table.blocks[bi]
        if self.refs[b] <= 1:
            return b
        nb = self.alloc(1, reservation)
        if nb is None:
            return None
        self.k[:, nb[0]] = self.k[:, b]
        self.v[:, nb[0]] = self.v[:, b]
        self.pos[nb[0]] = self.pos[b]
        self.release([b])
        # the CoW invariant: swap the table's index entry to the clone,
        # never touch the shared block's bytes — readers of ``b`` (other
        # tables, canonical runs, exported slot-index rows) keep their
        # exact in-place view
        table.blocks[bi] = nb[0]
        self._dirty.add(nb[0])
        self.counters.cow_clones += 1
        return nb[0]

    def write_rows(self, table: BlockTable, slots: np.ndarray,
                   k_rows: np.ndarray, v_rows: np.ndarray,
                   pos_rows: np.ndarray,
                   reservation: Optional[Reservation] = None) -> bool:
        """Overwrite individual table slots (the recompute-fixup rows of
        a hit chunk): k_rows/v_rows [L, n, Hkv, D] land at table slot
        indices ``slots`` [n]. Blocks shared with other holders are
        CoW-cloned first, so the canonical run (and every other reader)
        keeps its bytes."""
        bs = self.block_size
        for bi in sorted({int(s) // bs for s in slots}):
            if self._cow_block(table, bi, reservation) is None:
                return False
        for j, s in enumerate(np.asarray(slots, np.int64)):
            b = table.blocks[int(s) // bs]
            off = int(s) % bs
            self.k[:, b, off] = k_rows[:, j]
            self.v[:, b, off] = v_rows[:, j]
            self.pos[b, off] = pos_rows[j]
            self._dirty.add(b)
        return True

    def append_token(self, table: BlockTable, k_tok: np.ndarray,
                     v_tok: np.ndarray, pos: int,
                     reservation: Optional[Reservation] = None) -> bool:
        """k_tok/v_tok [L, Hkv, D]: append one decoded token's KV."""
        idx = table.length
        bi, off = divmod(idx, self.block_size)
        if bi >= len(table.blocks):
            got = self.alloc(1, reservation)
            if got is None:
                return False
            table.blocks.extend(got)
            self._zero_block(got[0])
        b = self._cow_block(table, bi, reservation)
        if b is None:
            return False
        self.k[:, b, off] = k_tok
        self.v[:, b, off] = v_tok
        self.pos[b, off] = pos
        self._dirty.add(b)
        table.length = idx + 1
        return True

    def ensure_append_slot(self, table: BlockTable,
                           reservation: Optional[Reservation] = None
                           ) -> Optional[int]:
        """Pre-open the slot the next ``append_token`` will land in:
        allocate the tail block if the table is full and CoW-clone it if
        shared, WITHOUT advancing ``table.length``. Returns the pool-flat
        slot id (``block_id * block_size + offset``) or None when the
        pool cannot supply a block. The paged decode step calls this
        before tracing so the jitted attention pass can scatter the new
        token's KV directly into the pool view; the later
        ``append_token`` for the same slot finds the block present and
        unshared and only fills the host mirror."""
        bi, off = divmod(table.length, self.block_size)
        if bi >= len(table.blocks):
            got = self.alloc(1, reservation)
            if got is None:
                return None
            table.blocks.extend(got)
            self._zero_block(got[0])
            # fresh block: a device twin may hold a stale previous
            # tenant — force sync
            self._dirty.add(got[0])
        b = self._cow_block(table, bi, reservation)
        if b is None:
            return None
        return b * self.block_size + off

    def gather(self, table: BlockTable, pad_to: int,
               compact: bool = False):
        """Block table -> dense [L, pad_to, Hkv, D] view (+ pos [pad_to]).

        An empty table (``length == 0`` / no blocks) returns a
        well-formed all-padding view: zero KV, positions all -1.

        ``compact=True`` strips the block-aligned layout's internal
        padding and orders tokens by logical position — the decode
        arena MUST use this view so attention reductions see the exact
        same operand layout whether the table was built by the copy or
        the zero-copy write-back (interleaved padding is numerically
        inert but shifts reduction groupings, breaking bit-equality)."""
        if table.length == 0 or not table.blocks:
            k = np.zeros((self.L, pad_to) + self.k.shape[3:], self.k.dtype)
            v = np.zeros_like(k)
            pos = np.full(pad_to, -1, np.int32)
            return k, v, pos
        bs = self.block_size
        n = self.blocks_needed(table.length)
        ids = np.asarray(table.blocks[:n], np.int64)
        k = self.k[:, ids].reshape(self.L, n * bs, *self.k.shape[3:])
        v = self.v[:, ids].reshape(self.L, n * bs, *self.v.shape[3:])
        pos = self.pos[ids].reshape(n * bs).copy()
        pos[table.length:] = -1
        if compact:
            idx = np.where(pos >= 0)[0]
            order = idx[np.argsort(pos[idx], kind="stable")]
            if order.size and (order == np.arange(order.size)).all():
                # copy-path tables are already compact (a contiguous
                # sorted prefix): slice the tail padding off without
                # the full fancy-index copy — the decode hot path
                m = order.size
                k, v, pos = k[:, :m], v[:, :m], pos[:m]
            else:
                k = k[:, order]
                v = v[:, order]
                pos = pos[order]
        S = pos.shape[0]
        if S < pad_to:
            padw = ((0, 0), (0, pad_to - S), (0, 0), (0, 0))
            k = np.pad(k, padw)
            v = np.pad(v, padw)
            pos = np.pad(pos, (0, pad_to - S), constant_values=-1)
        return k[:, :pad_to], v[:, :pad_to], pos[:pad_to]

    # ---- paged decode exports ---------------------------------------------
    def block_view(self):
        """Zero-copy view of the block arenas: ``(k, v, pos)`` with
        shapes ``[L, num_blocks, block, Hkv, D]`` / ``[num_blocks,
        block]``. No bytes are copied — every pool write is visible
        through the view immediately, and the CoW swap invariant (see
        module docstring) is what keeps concurrently-exported
        slot-index rows safe against it."""
        return self.k, self.v, self.pos

    def table_slot_index(self, table: BlockTable, pad_to: int
                         ) -> np.ndarray:
        """Compact pool-flat slot-index row for one table: ``out[i]`` is
        the flat arena slot (``block * block_size + offset``) holding
        the token at logical position ``i``; ``-1`` pads to ``pad_to``.
        Indexing the flattened arenas with this row reproduces
        ``gather(table, pad_to, compact=True)`` element-for-element, so
        a paged attention pass that dereferences it sees the exact
        operand layout of the arena path — the bit-identity seam."""
        out = np.full(pad_to, -1, np.int32)
        if table.length == 0 or not table.blocks:
            return out
        bs = self.block_size
        n = self.blocks_needed(table.length)
        ids = np.asarray(table.blocks[:n], np.int64)
        flat = (ids[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
        pos = self.pos[ids].reshape(n * bs).copy()
        pos[table.length:] = -1
        idx = np.where(pos >= 0)[0]
        order = idx[np.argsort(pos[idx], kind="stable")]
        m = min(order.size, pad_to)
        out[:m] = flat[order[:m]]
        return out

    def table_block_row(self, table: BlockTable, pad_to: int
                        ) -> np.ndarray:
        """Block-id row (-1 padded) for the paged Pallas kernel's
        scalar-prefetched index maps. Unlike ``table_slot_index`` this
        keeps the table's physical block order — the kernel masks
        per-slot by pool position instead of compacting. All held
        blocks are included (a pre-opened append block past
        ``table.length`` carries ``pos == -1`` slots the kernel masks
        anyway)."""
        out = np.full(pad_to, -1, np.int32)
        n = min(len(table.blocks), pad_to)
        if n:
            out[:n] = table.blocks[:n]
        return out

    def dirty_blocks(self) -> List[int]:
        """Block ids whose host bytes changed since the last
        ``clear_dirty`` — the device-twin upload set."""
        return sorted(self._dirty)

    def clear_dirty(self, blocks) -> None:
        self._dirty.difference_update(blocks)

    def free_table(self, table: BlockTable):
        self.release(table.blocks)
        table.blocks = []
        table.length = 0

    def reclaim_request(self, table: BlockTable,
                        reservation: Optional[Reservation]) -> int:
        """Tear down one request's pool state mid-flight (preemption,
        expiry, requeue): release the table's blocks and cancel the
        reservation in one step. Shared refcounts are respected — a
        block a canonical run or another table still references stays
        live, so only the request's *private* share returns to the free
        list — and the conservation law holds across the compound op
        even when the reservation was partially drawn into the table
        (drawn blocks come back via the release, undrawn via the
        cancel; nothing is double-freed because ``_take`` pops drawn
        blocks out of the reservation). Returns the number of blocks
        returned to the free list."""
        before = len(self.free)
        self.free_table(table)
        self.cancel(reservation)
        return len(self.free) - before
