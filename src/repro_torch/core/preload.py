"""Layer-wise preload scheduling (paper §3.4.2, Eq. 16, Algorithm 2) and
the streamed tier-load pipeline that executes it.

``preload_depth``/``layerwise_schedule`` are the paper's math: how many
layers of chunk-cache must be resident before execution starts so the
remaining per-layer loads hide behind per-layer compute, and which
layers to prefetch at each compute step. ``LayerStream`` makes the
schedule *real*: it drives layer-granular background loads of a
layer-sliced variant (``ChunkStore.get_kv_layer``) through the tier
store's preload worker, and the executor blocks on ``await_layer`` only
when a layer has not finished loading by the time its compute window
needs it — so ``load_exposed`` is measured at actual await points, not
modeled (CacheBlend-style fetch/compute overlap).

With quantized tiers (``core.tiers`` "Quantized tiers") the background
load ALSO pays the per-layer dequantize inside ``TieredStore.get`` on
the worker lane, so dequant cost hides behind the layerwise stream
exactly like the IO does; ``await_layer`` always hands the executor a
raw fp32 slice. Per-layer ``LoadInfo``s carry ``[t0, t1)`` interval
stamps so ``merge_load_infos`` can union concurrent lane loads instead
of double-counting overlapped wall time."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def preload_depth(num_layers: int, t_prefill: float, t_load: float) -> int:
    """Eq. 16: how many layers of chunk-cache to preload before execution
    starts so that per-layer loading hides behind per-layer compute."""
    if t_load <= t_prefill or t_load <= 0:
        return 1
    lp = (num_layers - 1) * (1.0 - t_prefill / t_load) + 1
    return max(1, min(num_layers, int(round(lp))))


@dataclass
class PreloadSchedule:
    depth: int
    # (layer_to_compute, layers_to_prefetch) per step — Algorithm 2
    steps: List[Tuple[int, List[int]]]


def layerwise_schedule(num_layers: int, t_prefill: float,
                       t_load: float) -> PreloadSchedule:
    lp = preload_depth(num_layers, t_prefill, t_load)
    steps = []
    fetched = 0
    for i in range(num_layers):
        want = min(num_layers, i + lp)
        pre = list(range(fetched, want))
        fetched = max(fetched, want)
        steps.append((i, pre))
    return PreloadSchedule(depth=lp, steps=steps)


class LayerStream:
    """Background, layer-granular load of one variant's stored KV.

    ``request(layers)`` enqueues loads on the tier store's preload
    worker (synchronous fallback when the store runs workerless, e.g.
    in deterministic tests); ``await_layer(l)`` returns layer ``l``'s
    dequantized slice, blocking only if the background load has not
    completed — the blocked wall time accumulates in
    ``blocked_seconds`` and the hidden/blocked split in the counters.
    ``trace`` records (event, layer, t_monotonic) tuples
    (``"requested"``/``"loaded"``) that tests join with the executor's
    window-start events to assert real compute/load overlap."""

    def __init__(self, store, variant):
        assert variant.num_layers, "LayerStream needs a layered variant"
        self.store = store
        self.var = variant
        L = variant.num_layers
        self._events = [threading.Event() for _ in range(L)]
        self._vals: List[Optional[dict]] = [None] * L
        self._infos: List[Optional[object]] = [None] * L
        self._errors: List[Optional[BaseException]] = [None] * L
        self._requested = [False] * L
        self.blocked_seconds = 0.0
        self.blocked_layers = 0
        self.hidden_layers = 0
        self.trace: List[Tuple[str, int, float]] = []

    @property
    def num_layers(self) -> int:
        return self.var.num_layers

    def request(self, layers):
        """Schedule background loads for ``layers`` (idempotent)."""
        tiers = self.store.tiers
        for l in layers:
            if self._requested[l]:
                continue
            self._requested[l] = True
            self.trace.append(("requested", l, time.monotonic()))
            if tiers._worker is not None:
                tiers.submit(lambda l=l: self._load(l))
            else:
                self._load(l)

    def _load(self, layer: int):
        try:
            kv, info = self.store.get_kv_layer(self.var, layer)
            self._vals[layer] = kv
            self._infos[layer] = info
            self.trace.append(("loaded", layer, time.monotonic()))
        except BaseException as e:        # noqa: BLE001 — re-raised at
            self._errors[layer] = e       # the await point
            raise
        finally:
            # ALWAYS release the awaiter: a failed load must fail fast
            # at await_layer with the real cause, not hang the executor
            # until the timeout and then blame a dead worker
            self._events[layer].set()

    def await_layer(self, layer: int, timeout: float = 30.0):
        """Block until layer ``layer`` is resident; returns
        (kv_slice, LoadInfo). Counts whether the load was already
        hidden behind earlier compute or actually exposed here. A load
        that failed in the background re-raises its error here."""
        self.request([layer])
        ev = self._events[layer]
        if ev.is_set():
            self.hidden_layers += 1
        else:
            self.blocked_layers += 1
            t0 = time.perf_counter()
            if not ev.wait(timeout):
                raise TimeoutError(
                    f"layer {layer} of {self.var.variant_id} never "
                    f"loaded (worker dead?)")
            self.blocked_seconds += time.perf_counter() - t0
        if self._errors[layer] is not None:
            raise RuntimeError(
                f"background load of layer {layer} of "
                f"{self.var.variant_id} failed") from self._errors[layer]
        return self._vals[layer], self._infos[layer]

    def loads_after(self, t: float) -> List[int]:
        """Layers whose load completed after monotonic time ``t`` —
        the overlap witness tests assert on."""
        return [l for ev, l, tt in self.trace
                if ev == "loaded" and tt > t]
