"""Hierarchical chunk-cache storage: HBM -> host memory -> SSD (§3.5).

On this CPU-only box the "HBM" tier is the in-process working set, the
"CPU" tier is a separate host dict with a modeled PCIe transfer cost, and
the SSD tier is *real files* (np.savez to disk), so SSD load costs in the
preloading benchmark are measured, not simulated. An asynchronous
preloader thread promotes caches toward HBM while requests wait in the
queue (§3.5), and the layer-wise schedule (Eq. 16) streams per-layer
slices during execution (``core.preload.LayerStream``).

Cache-manager architecture (eviction-policy contract)
-----------------------------------------------------
Victim selection is delegated to one pluggable ``EvictionPolicy``
(``core.eviction``) shared with the chunk store's variant capping and
the pool-run reclaim: ``_make_room`` builds a ``Candidate`` per
unpinned resident key — ``nbytes`` from the size ledger,
``last_access`` from the LRU clock, reuse stats from ``stats_fn`` (the
chunk store wires its per-variant ``f_r``/token-count feed here via
``attach_stats``) — and demotes whatever the policy scores lowest.
The default ``LRUPolicy`` reproduces the historical recency-only
demotion bit-for-bit; ``ReuseAwarePolicy`` keeps frequently-reused
variants resident (fewer tier misses on skewed workloads — gated by
``fig22_eviction_{lru,reuse}``).

Pinning is group-aware: the chunk store pins a *variant id* while its
canonical run is pool-resident, and every per-layer tier key of that
variant (``<vid>@L<nn>``) is excluded from demotion through
``group_fn`` (identity by default).

SSD accounting and restart persistence
--------------------------------------
``used["ssd"]`` tracks exactly the keys with a resident ``.npz`` file
(``ssd_keys`` ledger): rewrites are idempotent, promotion to HBM
removes the stale SSD copy (file and count), and ``delete`` reconciles
by ledger, not by guess. Each ``.npz`` embeds its pytree structure and
byte size (``__struct__``/``__nbytes__`` members), so a fresh
``TieredStore`` over an existing ``ssd_dir`` re-registers old entries
at construction and can ``get`` them without any in-memory sidecar
(the historical ``_structs`` dict is now just a read cache).

Background workers (per-tier lanes)
-----------------------------------
Preload work runs on a small per-tier thread pool: one task queue per
lane ("cpu", "ssd", "misc"), each with ``workers`` consumer threads,
so a slow SSD read never serializes CPU->HBM promotions queued behind
it. ``prefetch`` routes (key, ticket) promotions by the key's current
tier at enqueue time; arbitrary callables (``submit`` — used by
``LayerStream`` for layer-granular loads) land on the "misc" lane
unless a tier hint is given. Completion is tracked per lane with
``queue.task_done``/``unfinished_tasks``, so ``drain`` cannot return
while any worker still holds an in-flight item (the historical
empty-queue race); worker exceptions are counted in
``stats["preload_errors"]`` instead of being silently swallowed.
Prefetches carry an optional ``PrefetchTicket``; cancelling the ticket
(request preempted/expired/plan changed) retracts every pending
promotion it covers (``stats["prefetch_cancelled"]``).

Quantized tiers (trade bits for capacity, §3.5 + paper §7 note)
---------------------------------------------------------------
Chunk KV tolerates aggressive compression (CacheClip, TurboRAG), so
the non-HBM tiers can hold 4-10x more variants at the same byte budget
by storing a quantized representation. ``tier_dtypes`` maps a tier to
its storage scheme:

* ``"fp32"`` (default for both tiers) — raw pass-through, the legacy
  bit-exact behavior;
* ``"int8"`` — per-HEAD scales for KV-shaped leaves (ndim >= 3, head
  axis ``-2``): one fp32 scale per head, so a head with small
  activations is not crushed by an outlier head's range (4x fewer
  bytes; legacy per-tensor-scale files still decode). Leaves without a
  head axis keep the per-tensor scale, the quantize/dequantize idiom
  lifted from ``distributed/compression.py``;
* ``"fp8"`` — blockwise float8_e4m3fn, one fp32 scale per
  ``FP8_BLOCK`` elements (~4x fewer bytes, better dynamic range for
  outlier-heavy tensors; degrades to ``int8`` when ``ml_dtypes`` is
  unavailable).

Demotion *encodes* for the destination tier (HBM always holds the raw
fp32 value the executor computes with); promotion and ``get``
*dequantize* before returning — reads issued through the per-tier
worker lanes (prefetch, ``LayerStream``) pay the dequant cost on the
lane, hidden behind compute. An already-encoded value passes further
demotions through unchanged, so a value is quantized at most ONCE (no
error accumulation across cpu -> ssd -> cpu round trips). Non-float
leaves and float leaves below ``QUANT_MIN_ELEMS`` elements (per-token
scale sidecars, position vectors) are stored raw inside the encoded
tree.

The ledger counts STORED bytes: ``sizes[key]`` / ``used[tier]`` /
``Candidate.nbytes`` all reflect the representation resident in the
key's current tier, so the conservation invariant
``used[t] == sum(sizes of keys resident in t)`` holds across a
quantize-on-demote / dequantize-on-promote round trip and the eviction
policy prices entries by the bytes they actually occupy. SSD files
embed the scheme tag and per-leaf scales (``__scheme__``, ``s<i>``
members) next to ``__struct__``/``__nbytes__``; legacy fp32 files load
unchanged. Quality is gated by ``benchmarks/quality_vs_recompute.py``
(quantized score delta vs fp32 <= eps at matched recompute ratio) and
capacity by ``fig22_eviction_quant`` (strictly fewer deep tier misses
at an equal byte budget).

SSD entropy coding (``tier_compress``)
--------------------------------------
Quantized payloads still carry entropy the disk does not need to
store: ``tier_compress={"ssd": "zstd"}`` compresses the serialized
``.npz`` byte stream before it hits the SSD tier (composing with
``tier_dtypes`` — quantize first, entropy-code the quantized bytes).
Codecs: ``"zstd"`` (the ``zstandard`` package, import-gated — when it
is absent the store degrades to ``"zlib"`` and counts the fallback in
``stats["ssd_codec_fallbacks"]``, it never fails construction),
``"zlib"`` (stdlib, always available), ``"none"`` (legacy raw
``.npz``). Compressed entries live in ``<key>.npz.zst`` /
``<key>.npz.dfl`` files; the ledger counts the COMPRESSED on-disk
bytes (that is what the tier stores and what an SSD read moves), and
``stats["ssd_compress_saved"]`` accumulates raw-minus-stored. Reads
auto-detect the suffix, so legacy plain ``.npz`` files written before
compression was enabled keep loading, and the restart scan registers
both kinds.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import queue
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.eviction import Candidate, EvictionPolicy, LRUPolicy

# modeled bandwidths for load-time accounting (A100-class host, paper §5.1.1)
CPU_TO_HBM_GBPS = 64.0     # PCIe 4.0 x16
SSD_GBPS = 16.0            # NVMe read

TIER_RANK = {"hbm": 0, "cpu": 1, "ssd": 2}


def tree_nbytes(tree) -> int:
    total = 0
    for leaf in _leaves(tree):
        total += leaf.size * leaf.dtype.itemsize
    return total


# ---- quantized stored representations (module docstring) -------------------

QUANT_SCHEMES = ("fp32", "int8", "fp8")
QUANT_MIN_ELEMS = 64       # float leaves smaller than this stay raw
FP8_BLOCK = 128            # elements per fp8 scale block

try:                       # ml_dtypes ships with jax; gate, never install
    import ml_dtypes as _ml_dtypes
    _FP8_DTYPE: Optional[np.dtype] = np.dtype(_ml_dtypes.float8_e4m3fn)
    _FP8_MAX = float(_ml_dtypes.finfo(_ml_dtypes.float8_e4m3fn).max)
except Exception:          # pragma: no cover - jax guarantees ml_dtypes
    _FP8_DTYPE = None
    _FP8_MAX = 0.0

# ---- SSD entropy coding (module docstring "SSD entropy coding") ------------

COMPRESS_CODECS = ("none", "zlib", "zstd")
# codec -> (file suffix appended to ".npz", compress, decompress).
# zlib level 1: chunk KV payloads (quantized or fp32 mantissa soup) get
# most of their win from the match stage — higher levels cost CPU on
# the demotion path for single-digit extra percent
_CODECS: Dict[str, tuple] = {
    "zlib": (".dfl", lambda b: zlib.compress(b, 1), zlib.decompress),
}
try:                       # import-gated: never installed on demand
    import zstandard as _zstd
    _CODECS["zstd"] = (".zst",
                       lambda b: _zstd.ZstdCompressor().compress(b),
                       lambda b: _zstd.ZstdDecompressor().decompress(b))
except Exception:
    pass
# every known suffix, for read-side auto-detection and cleanup
_COMPRESS_SUFFIXES = (".zst", ".dfl")


@dataclass
class QuantizedTree:
    """One pytree encoded for a quantized tier: original structure,
    per-leaf payloads (int8 / fp8, or raw pass-through for non-float
    and tiny leaves), per-leaf scales (``None`` marks a raw leaf), and
    the STORED byte count (payloads + scales) the ledger accounts."""
    scheme: str
    struct: Any
    leaves: List[np.ndarray]
    scales: List[Optional[np.ndarray]]
    nbytes: int


def _quantize_leaf(x: np.ndarray, scheme: str):
    """-> (payload, scale | None). Non-float leaves and float leaves
    under ``QUANT_MIN_ELEMS`` pass through raw (scale sidecars and
    position vectors are precision-critical and save ~nothing)."""
    if x.dtype.kind != "f" or x.size < QUANT_MIN_ELEMS:
        return x, None
    xf = np.asarray(x, np.float32)
    if scheme == "int8":
        if xf.ndim >= 3:
            # KV-shaped leaf [..., H, D]: one scale per head (axis -2)
            # so a quiet head's resolution is not set by the loudest
            # head's outliers. The scale vector broadcasts back over
            # the trailing head_dim axis on dequant.
            red = tuple(i for i in range(xf.ndim) if i != xf.ndim - 2)
            scale = (np.abs(xf).max(axis=red) / 127.0
                     + 1e-12).astype(np.float32)
            q = np.clip(np.rint(xf / scale[:, None]), -127, 127) \
                .astype(np.int8)
            return q, scale
        scale = np.float32(np.abs(xf).max() / 127.0 + 1e-12)
        q = np.clip(np.rint(xf / scale), -127, 127).astype(np.int8)
        return q, np.asarray([scale], np.float32)
    # fp8: blockwise over the flattened leaf, one scale per FP8_BLOCK
    flat = xf.reshape(-1)
    pad = (-flat.size) % FP8_BLOCK
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, FP8_BLOCK)
    scale = (np.abs(blocks).max(axis=1, keepdims=True) / _FP8_MAX
             + 1e-12).astype(np.float32)
    q = (blocks / scale).astype(_FP8_DTYPE)
    payload = q.reshape(-1)[:xf.size].reshape(xf.shape)
    return payload, scale.reshape(-1)


def _dequantize_leaf(payload: np.ndarray, scale, scheme: str):
    if scale is None:
        return payload
    if scheme == "int8":
        if scale.size > 1:
            # per-head scale vector [H] over payload [..., H, D]
            return payload.astype(np.float32) \
                * scale.astype(np.float32)[:, None]
        # legacy per-tensor-scale entries (older SSD files; stored as
        # size-1 arrays, sometimes 0-d) decode through the scalar path
        return payload.astype(np.float32) \
            * np.float32(np.asarray(scale).reshape(-1)[0])
    flat = payload.astype(np.float32).reshape(-1)
    pad = (-flat.size) % FP8_BLOCK
    if pad:
        flat = np.pad(flat, (0, pad))
    out = (flat.reshape(-1, FP8_BLOCK)
           * scale.reshape(-1, 1).astype(np.float32)).reshape(-1)
    return out[:payload.size].reshape(payload.shape)


def quantize_tree(tree, scheme: str):
    """Encode ``tree`` for a quantized tier. ``"fp32"`` and an
    already-encoded tree return the input unchanged — a value is
    quantized at most once, so demotion chains never accumulate
    error."""
    if scheme == "fp32" or isinstance(tree, QuantizedTree):
        return tree
    if scheme == "fp8" and _FP8_DTYPE is None:
        scheme = "int8"
    if scheme not in QUANT_SCHEMES:
        raise ValueError(f"unknown quantization scheme {scheme!r}")
    payloads, scales = [], []
    for leaf in _leaves(tree):
        p, s = _quantize_leaf(np.asarray(leaf), scheme)
        payloads.append(p)
        scales.append(s)
    nb = sum(p.nbytes for p in payloads) \
        + sum(s.nbytes for s in scales if s is not None)
    return QuantizedTree(scheme=scheme, struct=_structure_of(tree),
                         leaves=payloads, scales=scales, nbytes=int(nb))


def dequantize_tree(value):
    """Stored representation -> the raw pytree ``get`` returns (fp32
    within the scheme's error bound; raw trees pass through)."""
    if not isinstance(value, QuantizedTree):
        return value
    leaves = [_dequantize_leaf(p, s, value.scheme)
              for p, s in zip(value.leaves, value.scales)]
    return _unflatten(value.struct, leaves)


def stored_nbytes(value) -> int:
    """Bytes the value occupies in its CURRENT representation — what
    the tier ledger and eviction candidates must account."""
    if isinstance(value, QuantizedTree):
        return value.nbytes
    return tree_nbytes(value)


def quant_error_bound(x, scheme: str) -> float:
    """Worst-case per-element abs error of one quantize/dequantize
    round trip of ``x`` (test helper). For int8 this is the PER-TENSOR
    bound — per-head scales (KV-shaped leaves) can only shrink the
    scale, so it upper-bounds them too; ``int8_head_error_bounds``
    gives the tight per-head figures."""
    m = float(np.abs(np.asarray(x, np.float32)).max())
    if scheme == "int8":
        return m / 127.0 * 0.51 + 1e-9
    return m * 0.08 + 1e-9      # e4m3: <= 2^-4 relative + scale margin


def int8_head_error_bounds(x) -> np.ndarray:
    """Per-head worst-case abs error [H] of the int8 per-head-scale
    round trip of a KV-shaped leaf ``[..., H, D]`` (test helper): each
    head's bound follows its own max, not the whole tensor's."""
    xf = np.asarray(x, np.float32)
    red = tuple(i for i in range(xf.ndim) if i != xf.ndim - 2)
    return np.abs(xf).max(axis=red) / 127.0 * 0.51 + 1e-9


def _leaves(tree):
    if isinstance(tree, dict):
        for _, v in sorted(tree.items()):
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


@dataclass
class LoadInfo:
    tier: str
    seconds_measured: float     # wall time actually spent in this process
    seconds_modeled: float      # bandwidth-model cost (GPU deployment)
    nbytes: int                 # STORED bytes moved (quantized if the
                                # source tier quantizes)
    t0: float = 0.0             # perf_counter window of the load, for
    t1: float = 0.0             # overlap-aware merging (t1 > t0)


def merge_load_infos(infos) -> Optional[LoadInfo]:
    """Aggregate per-layer LoadInfos into one variant-level record:
    deepest tier touched, bytes and modeled seconds summed (the
    bandwidth model is serial per link), measured seconds as the
    INTERVAL UNION of the per-load ``[t0, t1)`` windows — per-layer
    loads run concurrently on the per-tier lanes, so summing their
    durations double-counts overlapped wall time and could report more
    measured time than actually elapsed. Infos without interval stamps
    (hand-built) fall back to summing their durations."""
    infos = [i for i in infos if i is not None]
    if not infos:
        return None
    tier = max((i.tier for i in infos), key=TIER_RANK.__getitem__)
    spans = sorted((i.t0, i.t1) for i in infos if i.t1 > i.t0)
    measured = sum(i.seconds_measured for i in infos if i.t1 <= i.t0)
    end: Optional[float] = None
    for lo, hi in spans:
        if end is None or lo > end:
            measured += hi - lo
        elif hi > end:
            measured += hi - end
        end = hi if end is None else max(end, hi)
    return LoadInfo(tier,
                    measured,
                    sum(i.seconds_modeled for i in infos),
                    sum(i.nbytes for i in infos),
                    t0=spans[0][0] if spans else 0.0,
                    t1=end if end is not None else 0.0)


@dataclass
class PrefetchTicket:
    """Cancellation handle covering a request's pending promotions.

    The worker checks ``cancelled`` right before serving each queued
    promotion, so a cancel retracts every entry that has not started
    loading yet (entries already served stay promoted — harmless)."""
    cancelled: bool = False

    def cancel(self):
        self.cancelled = True


class TieredStore:
    """Capacity-bounded three-tier KV store with policy-driven demotion
    and an asynchronous promotion (preload) worker."""

    def __init__(self, hbm_bytes: int, cpu_bytes: int, ssd_dir: str,
                 start_worker: bool = True,
                 policy: Optional[EvictionPolicy] = None,
                 workers: int = 1,
                 tier_dtypes: Optional[Dict[str, str]] = None,
                 tier_compress: Optional[Dict[str, str]] = None):
        self.caps = {"hbm": hbm_bytes, "cpu": cpu_bytes}
        self.used = {"hbm": 0, "cpu": 0, "ssd": 0}
        self.hbm: Dict[str, Any] = {}
        self.cpu: Dict[str, Any] = {}
        self.ssd_dir = ssd_dir
        os.makedirs(ssd_dir, exist_ok=True)
        # per-tier storage schemes (module docstring "Quantized tiers"):
        # HBM always holds raw fp32; cpu/ssd default to the legacy
        # bit-exact pass-through unless configured to quantize
        self.tier_dtypes = {"hbm": "fp32", "cpu": "fp32", "ssd": "fp32"}
        for t, s in (tier_dtypes or {}).items():
            if t not in ("cpu", "ssd"):
                raise ValueError(f"tier_dtypes: unknown tier {t!r}")
            if s not in QUANT_SCHEMES:
                raise ValueError(f"tier_dtypes: unknown scheme {s!r}")
            if s == "fp8" and _FP8_DTYPE is None:
                s = "int8"           # ml_dtypes absent: degrade, never fail
            self.tier_dtypes[t] = s
        # SSD entropy coding (module docstring): resolve the configured
        # codec once, degrading zstd -> zlib when the package is absent
        # (counted, never a construction failure)
        self._codec_fallbacks = 0
        self.ssd_codec = "none"
        for t, c in (tier_compress or {}).items():
            if t != "ssd":
                raise ValueError(f"tier_compress: unknown tier {t!r} "
                                 "(only 'ssd' supports entropy coding)")
            if c not in COMPRESS_CODECS:
                raise ValueError(f"tier_compress: unknown codec {c!r}")
            if c != "none" and c not in _CODECS:
                self._codec_fallbacks += 1
                c = "zlib"           # stdlib: always available
            self.ssd_codec = c
        self.sizes: Dict[str, int] = {}
        self.lru: Dict[str, float] = {}
        # per-key write generation: ``get`` snapshots it at the hit and
        # ``_promote`` refuses to install a value whose key was deleted
        # or overwritten while the (lock-free) slow read was in flight —
        # without it a concurrent ``put`` could be resurrected over by
        # the stale value, and a concurrent ``delete`` undone
        self._gen: Dict[str, int] = {}
        self._gen_counter = itertools.count(1)
        # pin counts: pool-resident chunk caches are read by every
        # hitting prefill's compute pass, so demotion skips them (one
        # count per pool-resident run referencing the key). Pins are
        # group-aware: a pin on ``group_fn(key)`` covers ``key`` (the
        # chunk store pins a variant id, covering its layer slices).
        self.pins: Dict[str, int] = {}
        self.policy: EvictionPolicy = policy or LRUPolicy()
        # stats_fn(key) -> (reuse_freq, recompute_cost): the chunk
        # store's per-variant feed for reuse-aware candidates
        self.stats_fn: Optional[Callable[[str], tuple]] = None
        self.group_fn: Callable[[str], str] = lambda k: k
        # per-load artificial latency (seconds) for non-HBM tiers:
        # bench/test hook that makes load-vs-compute overlap observable
        # and deterministic on fast local disks
        self.load_delay_s = 0.0
        self.lock = threading.RLock()
        self.stats = {"hits": {"hbm": 0, "cpu": 0, "ssd": 0},
                      "demotions": 0, "promotions": 0,
                      "preload_errors": 0, "prefetch_cancelled": 0,
                      "quant_bytes_saved": 0, "dequant_loads": 0,
                      "ssd_compress_saved": 0,
                      "ssd_codec_fallbacks": self._codec_fallbacks}
        # ssd residency ledger: key -> bytes accounted in used["ssd"]
        self.ssd_keys: Dict[str, int] = {}
        self._structs: Dict[str, Any] = {}
        self._scan_ssd_dir()
        # Per-tier task queues: a slow SSD read no longer serializes
        # behind-it CPU->HBM promotions (and vice versa). ``prefetch``
        # routes by the key's current tier at enqueue time; ``submit``
        # jobs land on the "misc" lane unless the caller hints a tier.
        # ``workers`` is the pool size PER TIER — tier loads are
        # IO/latency-bound, so even 1 thread per lane deepens
        # streamed-load overlap under a busy main thread.
        self._qs: Dict[str, "queue.Queue[Any]"] = {
            lane: queue.Queue() for lane in ("cpu", "ssd", "misc")}
        self._pool: list = []
        if start_worker:
            for lane_q in self._qs.values():
                for _ in range(max(1, workers)):
                    t = threading.Thread(target=self._preload_loop,
                                         args=(lane_q,), daemon=True)
                    t.start()
                    self._pool.append(t)
        self._worker = self._pool[0] if self._pool else None

    def attach_stats(self, stats_fn: Callable[[str], tuple],
                     group_fn: Optional[Callable[[str], str]] = None):
        """Wire the chunk store's per-key reuse stats (and pin-group
        aliasing) into candidate construction."""
        self.stats_fn = stats_fn
        if group_fn is not None:
            self.group_fn = group_fn

    def _unplace(self, key: str):
        """Remove ``key``'s current residency (any tier) from the
        accounting — the re-``put`` reconciliation that keeps
        ``used[tier] == sum(sizes of resident keys)`` exact when a key
        is overwritten, possibly with a different size."""
        nb_old = self.sizes.get(key, 0)
        if key in self.hbm:
            self.hbm.pop(key)
            self.used["hbm"] -= nb_old
        if key in self.cpu:
            self.cpu.pop(key)
            self.used["cpu"] -= nb_old
        if key in self.ssd_keys:
            self.used["ssd"] -= self.ssd_keys.pop(key)
            self._remove_ssd_files(key)

    # ---- placement -------------------------------------------------------
    def _encode(self, tier: str, value):
        """Encode ``value`` for ``tier``'s storage scheme and account
        the bytes saved (already-encoded trees pass through — a value
        is quantized at most once)."""
        enc = quantize_tree(value, self.tier_dtypes.get(tier, "fp32"))
        if isinstance(enc, QuantizedTree) \
                and not isinstance(value, QuantizedTree):
            self.stats["quant_bytes_saved"] += tree_nbytes(value) - enc.nbytes
        return enc

    def put(self, key: str, value, prefer: str = "hbm") -> str:
        with self.lock:
            self._unplace(key)
            self._gen[key] = next(self._gen_counter)
            self.lru[key] = time.monotonic()
            if prefer == "hbm":
                nb = tree_nbytes(value)
                if self._make_room("hbm", nb):
                    self.hbm[key] = value
                    self.sizes[key] = nb
                    self.used["hbm"] += nb
                    return "hbm"
            if prefer in ("hbm", "cpu"):
                enc = self._encode("cpu", value)
                nb = stored_nbytes(enc)
                if self._make_room("cpu", nb):
                    self.cpu[key] = enc
                    self.sizes[key] = nb
                    self.used["cpu"] += nb
                    return "cpu"
            self._write_ssd(key, self._encode("ssd", value))
        return "ssd"

    def pin(self, key: str):
        """Exclude ``key`` (and every key whose ``group_fn`` maps to it)
        from tier demotion (counted; one count per pool-resident run
        referencing it)."""
        with self.lock:
            self.pins[key] = self.pins.get(key, 0) + 1

    def unpin(self, key: str):
        with self.lock:
            n = self.pins.get(key, 0) - 1
            if n <= 0:
                self.pins.pop(key, None)
            else:
                self.pins[key] = n

    def _pinned(self, key: str) -> bool:
        return key in self.pins or self.group_fn(key) in self.pins

    def _candidate(self, key: str, value=None) -> Candidate:
        freq, cost = (0.0, 1.0)
        if self.stats_fn is not None:
            freq, cost = self.stats_fn(key)
        nb = self.sizes.get(key)
        if nb is None:
            # never default a missing size to 1 byte: GDSF prices
            # candidates by cost/size, so a 1-byte default inflates the
            # priority ~1e6x and makes the key effectively unevictable.
            # Fall back to the value's real stored bytes instead.
            nb = stored_nbytes(value) if value is not None else 0
        return Candidate(key=key, nbytes=nb,
                         last_access=self.lru.get(key, 0.0),
                         reuse_freq=freq, recompute_cost=cost)

    def _make_room(self, tier: str, nb: int) -> bool:
        if nb > self.caps[tier]:
            return False
        store = self.hbm if tier == "hbm" else self.cpu
        while self.used[tier] + nb > self.caps[tier]:
            victim = self.policy.select(
                self._candidate(k, v) for k, v in store.items()
                if not self._pinned(k))
            if victim is None:
                return False
            self._demote(victim.key, tier)
        return True

    def _demote(self, key: str, tier: str):
        self.stats["demotions"] += 1
        if tier == "hbm":
            val = self.hbm.pop(key)
            self.used["hbm"] -= self.sizes[key]
            enc = self._encode("cpu", val)
            nb = stored_nbytes(enc)
            if self._make_room("cpu", nb):
                self.cpu[key] = enc
                self.sizes[key] = nb
                self.used["cpu"] += nb
            else:
                self._write_ssd(key, self._encode("ssd", enc))
        else:
            val = self.cpu.pop(key)
            self.used["cpu"] -= self.sizes[key]
            self._write_ssd(key, self._encode("ssd", val))

    def flush(self):
        """Demote everything demotable to SSD (bench/test helper: stage
        a cold-start state with all unpinned entries disk-resident)."""
        with self.lock:
            for key in [k for k in self.hbm if not self._pinned(k)]:
                if key in self.hbm:          # may cascade-demote earlier
                    self._demote(key, "hbm")
            for key in [k for k in self.cpu if not self._pinned(k)]:
                if key in self.cpu:
                    self._demote(key, "cpu")

    # ---- SSD persistence -------------------------------------------------
    def _ssd_path(self, key: str) -> str:
        """Path the CONFIGURED codec writes (plain ``.npz`` for
        ``none``, ``.npz.zst`` / ``.npz.dfl`` otherwise)."""
        base = os.path.join(self.ssd_dir, key + ".npz")
        if self.ssd_codec != "none":
            base += _CODECS[self.ssd_codec][0]
        return base

    def _find_ssd_file(self, key: str) -> Optional[str]:
        """Locate ``key``'s on-disk file whatever codec wrote it: the
        configured suffix first, then every other known suffix, then
        the legacy plain ``.npz`` — files written before compression
        was (re)configured keep loading."""
        base = os.path.join(self.ssd_dir, key + ".npz")
        for p in [self._ssd_path(key)] \
                + [base + s for s in _COMPRESS_SUFFIXES] + [base]:
            if os.path.exists(p):
                return p
        return None

    def _remove_ssd_files(self, key: str):
        base = os.path.join(self.ssd_dir, key + ".npz")
        for p in {base, *(base + s for s in _COMPRESS_SUFFIXES)}:
            if os.path.exists(p):
                os.remove(p)

    def _write_ssd(self, key: str, value):
        """Idempotent in the accounting: rewriting an existing key
        replaces its ``used["ssd"]`` contribution instead of inflating
        it. The pytree structure, STORED byte size, and quantization
        scheme are embedded in the file (``__struct__``/``__nbytes__``/
        ``__scheme__``; per-leaf scales as ``s<i>`` next to the ``a<i>``
        payloads) so a fresh store over this ``ssd_dir`` can reload the
        entry; legacy fp32 files simply lack the quant members."""
        flat = {}
        scheme = "fp32"
        if isinstance(value, QuantizedTree):
            scheme = value.scheme
            struct = value.struct
            for i, (p, s) in enumerate(zip(value.leaves, value.scales)):
                # fp8 payloads persist as uint8 views: npz headers only
                # round-trip builtin numpy dtypes
                flat[f"a{i}"] = p.view(np.uint8) \
                    if s is not None and scheme == "fp8" else p
                if s is not None:
                    flat[f"s{i}"] = s
        else:
            for i, leaf in enumerate(_leaves(value)):
                flat[f"a{i}"] = np.asarray(leaf)
            struct = _structure_of(value)
        nb = stored_nbytes(value)
        flat["__struct__"] = np.frombuffer(
            json.dumps(struct).encode(), np.uint8)
        flat["__nbytes__"] = np.int64(nb)
        flat["__scheme__"] = np.frombuffer(scheme.encode(), np.uint8)
        if self.ssd_codec == "none":
            np.savez(self._ssd_path(key), **flat)
        else:
            # entropy-code the serialized npz stream; the ledger then
            # counts the COMPRESSED bytes — what the tier actually
            # stores and what a read moves off the disk
            buf = io.BytesIO()
            np.savez(buf, **flat)
            raw = buf.getvalue()
            comp = _CODECS[self.ssd_codec][1](raw)
            with open(self._ssd_path(key), "wb") as f:
                f.write(comp)
            nb = len(comp)
            with self.lock:
                self.stats["ssd_compress_saved"] += len(raw) - nb
        with self.lock:
            # a rewrite under a different codec leaves no stale twin
            # behind another suffix
            keep = self._ssd_path(key)
            base = os.path.join(self.ssd_dir, key + ".npz")
            for p in {base, *(base + s for s in _COMPRESS_SUFFIXES)}:
                if p != keep and os.path.exists(p):
                    os.remove(p)
            self.sizes[key] = nb
            self.used["ssd"] += nb - self.ssd_keys.get(key, 0)
            self.ssd_keys[key] = nb
            self._structs[key] = struct

    def _read_ssd(self, key: str):
        """-> stored representation (raw pytree for fp32/legacy files,
        ``QuantizedTree`` for quantized ones) or ``None`` (miss). The
        file is located by suffix auto-detection, so entries written
        under any codec — or before compression existed — are served
        regardless of the store's current configuration."""
        path = self._find_ssd_file(key)
        if path is None:
            return None
        src: Any = path
        for suffix, _c, decompress in _CODECS.values():
            if path.endswith(suffix):
                with open(path, "rb") as f:
                    src = io.BytesIO(decompress(f.read()))
                break
        with np.load(src) as z:
            files = set(z.files)
            struct = self._structs.get(key)
            if struct is None:
                if "__struct__" not in files:
                    # pre-persistence file from a dead process: the
                    # pytree structure is unrecoverable — miss, not a
                    # KeyError crash (the scan never registers these)
                    return None
                struct = json.loads(bytes(z["__struct__"]).decode())
                self._structs[key] = struct
            scheme = bytes(z["__scheme__"]).decode() \
                if "__scheme__" in files else "fp32"
            if scheme == "fp8" and _FP8_DTYPE is None:
                return None     # pragma: no cover - fp8 file, no ml_dtypes
            n = sum(1 for f in files if f.startswith("a"))
            leaves: List[np.ndarray] = []
            scales: List[Optional[np.ndarray]] = []
            for i in range(n):
                p = z[f"a{i}"]
                s = z[f"s{i}"] if f"s{i}" in files else None
                if s is not None and scheme == "fp8":
                    p = p.view(_FP8_DTYPE)
                leaves.append(p)
                scales.append(s)
        if scheme == "fp32":
            return _unflatten(struct, leaves)
        nb = sum(p.nbytes for p in leaves) \
            + sum(s.nbytes for s in scales if s is not None)
        return QuantizedTree(scheme=scheme, struct=struct, leaves=leaves,
                             scales=scales, nbytes=int(nb))

    def _scan_ssd_dir(self):
        """Restart recovery: register every self-describing ``.npz``
        already in ``ssd_dir`` (size from the embedded ``__nbytes__``;
        structure loaded lazily on first read) so old entries survive a
        process restart. Files without the embedded metadata (written
        before persistence existed) are unreadable in a fresh process
        and stay unregistered — a miss, not a poisoned entry."""
        for fname in sorted(os.listdir(self.ssd_dir)):
            path = os.path.join(self.ssd_dir, fname)
            if fname.endswith(".npz"):
                # legacy / uncompressed entry: ledger counts the
                # embedded logical size
                key = fname[:-4]
                try:
                    with np.load(path) as z:
                        if "__nbytes__" not in z.files:
                            continue
                        nb = int(z["__nbytes__"])
                except (OSError, ValueError):
                    continue
            elif any(fname.endswith(".npz" + s)
                     for s in _COMPRESS_SUFFIXES):
                # entropy-coded entry: the suffix marks the codec and
                # the file IS the stored payload, so the on-disk size
                # is the ledger size
                key = fname[:fname.index(".npz")]
                try:
                    nb = os.path.getsize(path)
                except OSError:
                    continue
            else:
                continue
            self.sizes[key] = nb
            self.ssd_keys[key] = nb
            self.used["ssd"] += nb
            self.lru.setdefault(key, 0.0)

    # ---- retrieval -------------------------------------------------------
    def where(self, key: str) -> Optional[str]:
        with self.lock:
            if key in self.hbm:
                return "hbm"
            if key in self.cpu:
                return "cpu"
            if key in self.ssd_keys:
                # the ledger is authoritative (every write registers;
                # the restart scan registers every readable file) — a
                # bare on-disk file without metadata is not servable
                return "ssd"
        return None

    def get(self, key: str, promote: bool = True
            ) -> Tuple[Any, Optional[LoadInfo]]:
        t0 = time.perf_counter()
        src = None
        with self.lock:
            if key in self.hbm:
                self.lru[key] = time.monotonic()
                self.stats["hits"]["hbm"] += 1
                return self.hbm[key], LoadInfo("hbm", 0.0, 0.0,
                                               self.sizes[key])
            # snapshot everything the slow path needs UNDER the lock
            # (sizes read + generation token): a concurrent ``delete``
            # can no longer KeyError us and a concurrent ``put`` can no
            # longer be clobbered by a stale promote (gen check below)
            gen = self._gen.get(key)
            enc = self.cpu.get(key)
            if enc is not None:
                src, nb = "cpu", self.sizes[key]
            elif key in self.ssd_keys:
                src, nb = "ssd", self.sizes.get(key, self.ssd_keys[key])
            if src is not None:
                # EVERY hit advances the LRU clock, promoted or not —
                # with the clock only in the hbm branch and ``_promote``
                # layer-streamed (promote=False) reads looked idle to
                # the eviction policy and hot variants demoted first
                self.lru[key] = time.monotonic()
        if src is None:
            return None, None
        if src == "ssd":
            if self._find_ssd_file(key) is None:
                return None, None
            try:
                enc = self._read_ssd(key)
            except OSError:            # racing delete unlinked the file
                enc = None
            if enc is None:            # unreadable legacy file
                return None, None
        if self.load_delay_s:
            time.sleep(self.load_delay_s)
        if isinstance(enc, QuantizedTree):
            self.stats["dequant_loads"] += 1
        val = dequantize_tree(enc)
        gbps = CPU_TO_HBM_GBPS if src == "cpu" else SSD_GBPS
        with self.lock:
            self.stats["hits"][src] += 1
        t1 = time.perf_counter()
        info = LoadInfo(src, t1 - t0, nb / (gbps * 1e9), nb,
                        t0=t0, t1=t1)
        if promote:
            self._promote(key, val, gen=gen)
        return val, info

    def _promote(self, key: str, val, gen: Optional[int] = None):
        with self.lock:
            if gen is not None and self._gen.get(key) != gen:
                # key deleted or overwritten while the lock-free read
                # was in flight: installing ``val`` would resurrect a
                # stale value over the newer state — drop it
                return
            nb = tree_nbytes(val)      # HBM holds the raw fp32 value
            if key not in self.hbm and self._make_room("hbm", nb):
                if key in self.cpu:
                    self.cpu.pop(key)
                    self.used["cpu"] -= self.sizes.get(key, 0)
                if key in self.ssd_keys:
                    # reconcile: the HBM copy supersedes the SSD one —
                    # without this the stale file stayed counted forever
                    self.used["ssd"] -= self.ssd_keys.pop(key)
                    self._remove_ssd_files(key)
                self.hbm[key] = val
                self.sizes[key] = nb
                self.used["hbm"] += nb
                self.stats["promotions"] += 1
                self.lru[key] = time.monotonic()

    def delete(self, key: str):
        with self.lock:
            self._unplace(key)
            # bump (never pop) the generation: an in-flight get/promote
            # of this key must observe the change and drop its value
            self._gen[key] = next(self._gen_counter)
            self.sizes.pop(key, None)
            self.lru.pop(key, None)
            self.pins.pop(key, None)
            self._structs.pop(key, None)
            self._remove_ssd_files(key)    # incl. unregistered legacy

    # ---- async preloading (§3.5) ------------------------------------------
    def _lane(self, tier: Optional[str]) -> "queue.Queue[Any]":
        return self._qs.get(tier, self._qs["misc"])

    def prefetch(self, key: str, ticket: Optional[PrefetchTicket] = None):
        """Schedule promotion toward HBM while the request queues.
        ``ticket`` lets the caller retract the promotion later
        (request preempted/expired before serving). The promotion is
        routed to the queue of the key's *current* tier, so SSD reads
        and CPU->HBM promotions proceed in parallel."""
        self._lane(self.where(key)).put((key, ticket))

    def submit(self, job: Callable[[], Any],
               tier: Optional[str] = None):
        """Run an arbitrary job on a preload worker (layer-granular
        stream loads share the workers with queue-time promotions).
        ``tier`` optionally routes the job onto that tier's lane."""
        self._lane(tier).put(job)

    def _serve(self, item):
        if callable(item):
            item()
            return
        key, ticket = item
        if ticket is not None and ticket.cancelled:
            self.stats["prefetch_cancelled"] += 1
            return
        self.get(key, promote=True)

    def _preload_loop(self, lane_q: "queue.Queue[Any]"):
        while True:
            item = lane_q.get()
            try:
                if item is None:
                    return
                self._serve(item)
            except Exception:
                self.stats["preload_errors"] += 1
            finally:
                lane_q.task_done()

    def drain(self, timeout: float = 5.0):
        """Wait for outstanding prefetches on every lane (test/bench
        hook).

        Uses ``unfinished_tasks`` (not queue emptiness), so an item a
        worker already popped but is still serving keeps ``drain``
        blocked until its ``task_done``. Without worker threads the
        queues are served inline — deterministic for property tests."""
        if self._worker is None:
            for lane_q in self._qs.values():
                while True:
                    try:
                        item = lane_q.get_nowait()
                    except queue.Empty:
                        break
                    try:
                        if item is not None:
                            self._serve(item)
                    except Exception:
                        self.stats["preload_errors"] += 1
                    finally:
                        lane_q.task_done()
            return
        deadline = time.monotonic() + timeout
        for lane_q in self._qs.values():
            with lane_q.all_tasks_done:
                while lane_q.unfinished_tasks:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    lane_q.all_tasks_done.wait(remaining)

    def close(self):
        per_lane = len(self._pool) // len(self._qs) if self._pool else 0
        for lane_q in self._qs.values():
            for _ in range(per_lane):
                lane_q.put(None)        # one sentinel per lane worker
        for t in self._pool:
            t.join(timeout=2.0)
        self._pool = []
        self._worker = None


def _structure_of(tree):
    if isinstance(tree, dict):
        return {k: _structure_of(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_structure_of(v) for v in tree]
    return None


def _unflatten(struct, leaves):
    it = iter(leaves)

    def rec(s):
        if isinstance(s, dict):
            return {k: rec(v) for k, v in s.items()}
        if isinstance(s, list):
            return [rec(v) for v in s]
        return next(it)

    return rec(struct)
