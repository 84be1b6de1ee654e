"""Typed engine construction for the port: ``EngineSpec`` ->
``build_engine``, the one way engines are built (the launcher, the
benches and the tests all go through it)::

    spec = EngineSpec(strategy="cachecraft", attn_impl="kernel",
                      pool_blocks=512,
                      sched=SchedulerConfig(max_decode_batch=4))
    eng = build_engine(spec, cfg=cfg, params=params)

``build_engine`` validates the whole spec up front against the PORT's
registries (``repro_torch.models.backend.BACKENDS``), so a typo fails at
construction with a message naming the field. ``cfg`` / ``params`` /
``store`` can be injected; otherwise they are built from the spec:
``arch`` / ``tiny`` resolve the model config, ``params_path`` restores
trained parameters onto ``device`` (else ``seed`` random-inits them
there with a torch generator), and ``store`` (a ``StoreSpec``) builds
the tiered chunk store.

``device`` defaults to ``"cuda"``; without a GPU the caller must pass
``device="cpu"`` (the port never falls back on its own).
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional

from repro_torch.core.strategies import STRATEGIES as _STRATEGY_REGISTRY
from repro_torch.core.strategies import get_strategy
from repro_torch.serving.scheduler import SchedulerConfig

STRATEGIES = tuple(_STRATEGY_REGISTRY)
TIER_DTYPES = ("fp32", "int8", "fp8")
_UNSET = object()


@dataclass
class StoreSpec:
    """Chunk-store construction: tier capacities, variant caps, and the
    per-tier storage codecs (``tier_dtypes``, e.g. ``{"cpu": "int8"}``;
    ``tier_compress``, e.g. ``{"ssd": "zstd"}``). ``ssd_dir=None`` creates
    a throwaway temp dir."""
    hbm_bytes: int = 1 << 30
    cpu_bytes: int = 1 << 30
    ssd_dir: Optional[str] = None
    n_chunks: int = 100
    m_variants: int = 5
    alpha: float = 1.0
    start_worker: bool = True
    tier_dtypes: Optional[Dict[str, str]] = None
    tier_compress: Optional[Dict[str, str]] = None


@dataclass
class EngineSpec:
    """Everything needed to build a serving engine, typed."""
    # model identity (ignored when ``build_engine`` is given ``cfg`` /
    # ``params`` directly)
    arch: str = "llama3-8b"
    tiny: bool = True
    seed: int = 0
    # a checkpoint directory (``training/checkpoint.py``, written by
    # either package) whose ``params`` to serve instead of random ones
    params_path: Optional[str] = None
    # recompute strategy + executor behavior
    strategy: str = "cachecraft"
    use_focus: bool = True
    force_recompute_fraction: Optional[float] = None
    layerwise_load: bool = False
    store_fixed_variants: bool = True
    store_new_chunks: bool = True
    fix_rpe: bool = True
    fix_causality: bool = True
    # attention backend (None: "dense" prefill windows, "auto" decode) /
    # tensor-parallel serving mesh (``launch.mesh.make_serving_mesh``;
    # forces "sharded" and a head-sharded pool)
    attn_impl: Optional[str] = None
    mesh: Any = None
    # KV pool
    pool_blocks: int = 4096
    block_size: int = 16
    # scheduler
    sched: SchedulerConfig = field(default_factory=SchedulerConfig)
    # engine knobs
    decode_bucket_b: int = 4
    seq_bucket: int = 64
    time_scale: float = 1.0
    incremental_decode: bool = True
    share_chunk_kv: bool = True
    trace_decode: bool = False
    # paged decode: attention reads KV in place from a device twin of the
    # pool; ``attn_impl="paged_kernel"`` routes the CUDA paged kernel
    paged_decode: bool = False
    # chunk store (None -> no store, i.e. pure recompute serving)
    store: Optional[StoreSpec] = field(default_factory=StoreSpec)
    # where the model runs: "cuda" (default) or "cpu"
    device: str = "cuda"

    def validate(self):
        """Fail fast with the offending field named. Returns self."""
        get_strategy(self.strategy)  # unknown -> ValueError with the name
        if self.attn_impl is not None:
            from repro_torch.models.backend import BACKENDS
            if self.attn_impl not in BACKENDS:
                raise ValueError(
                    f"EngineSpec.attn_impl={self.attn_impl!r} not a "
                    f"registered backend {sorted(BACKENDS)}")
        if self.pool_blocks <= 0 or self.block_size <= 0:
            raise ValueError(
                f"EngineSpec pool_blocks/block_size must be positive "
                f"(got {self.pool_blocks}/{self.block_size})")
        if self.force_recompute_fraction is not None and \
                not 0.0 <= self.force_recompute_fraction <= 1.0:
            raise ValueError(
                "EngineSpec.force_recompute_fraction="
                f"{self.force_recompute_fraction} outside [0, 1]")
        if not isinstance(self.sched, SchedulerConfig):
            raise TypeError("EngineSpec.sched must be a SchedulerConfig, "
                            f"got {type(self.sched).__name__}")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f"EngineSpec.device={self.device!r}: 'cuda' "
                             "or 'cpu'")
        if self.store is not None:
            if not isinstance(self.store, StoreSpec):
                raise TypeError(
                    "EngineSpec.store must be a StoreSpec or None, "
                    f"got {type(self.store).__name__}")
            for tier, dt in (self.store.tier_dtypes or {}).items():
                if dt not in TIER_DTYPES:
                    raise ValueError(
                        f"StoreSpec.tier_dtypes[{tier!r}]={dt!r} not in "
                        f"{TIER_DTYPES}")
            if self.store.tier_compress:
                from repro_torch.core.tiers import COMPRESS_CODECS
                for tier, codec in self.store.tier_compress.items():
                    if tier != "ssd" or codec not in COMPRESS_CODECS:
                        raise ValueError(
                            f"StoreSpec.tier_compress[{tier!r}]="
                            f"{codec!r}: only the 'ssd' tier supports "
                            f"compression, with codecs "
                            f"{COMPRESS_CODECS}")
            if self.store.hbm_bytes <= 0 or self.store.cpu_bytes <= 0:
                raise ValueError("StoreSpec tier capacities must be "
                                 "positive")
        return self

    @classmethod
    def from_args(cls, args) -> "EngineSpec":
        """Build a spec from an ``argparse`` namespace (the launcher's
        flag surface); only attributes present on ``args`` are read."""
        def get(name, default):
            return getattr(args, name, default)

        spec = cls(
            arch=get("arch", cls.arch),
            tiny=not get("full", False),
            seed=get("seed", cls.seed),
            params_path=get("params", None),
            strategy=get("strategy", cls.strategy),
            use_focus=not get("no_focus", False),
            force_recompute_fraction=get("recompute", None),
            layerwise_load=get("layerwise_load", False),
            attn_impl=get("attn_impl", None),
            paged_decode=get("paged_decode", False),
            pool_blocks=get("pool_blocks", cls.pool_blocks),
            device=get("device", cls.device),
            sched=SchedulerConfig(
                max_batch_tokens=get("max_batch_tokens", 8192),
                max_decode_batch=get("max_decode_batch", 4)),
        )
        if not get_strategy(spec.strategy).needs_store:
            spec.store = None
        elif spec.store is not None:
            td = get("tier_dtypes", None)
            if td:
                pairs = (p.split("=", 1) for p in td.split(","))
                spec.store = replace(
                    spec.store,
                    tier_dtypes={k.strip(): v.strip() for k, v in pairs})
        return spec.validate()


def build_store(sspec: Optional[StoreSpec]):
    """Materialize a ``ChunkStore`` (or None) from a ``StoreSpec``."""
    if sspec is None:
        return None
    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.tiers import TieredStore
    ssd = sspec.ssd_dir or tempfile.mkdtemp(prefix="cc-store-")
    return ChunkStore(
        TieredStore(sspec.hbm_bytes, sspec.cpu_bytes, ssd,
                    start_worker=sspec.start_worker,
                    tier_dtypes=sspec.tier_dtypes,
                    tier_compress=sspec.tier_compress),
        n_chunks=sspec.n_chunks, m_variants=sspec.m_variants,
        alpha=sspec.alpha)


def build_cfg(spec: EngineSpec):
    """Resolve the model config named by ``arch``/``tiny``."""
    from repro_torch.configs import get_config, get_tiny
    return get_tiny(spec.arch) if spec.tiny else get_config(spec.arch)


def build_params(spec: EngineSpec, cfg):
    """Restore ``params_path`` onto ``spec.device``, or random-init from
    ``seed`` directly there. Restored params carry no grad."""
    import torch

    from repro_torch import device as devmod
    from repro_torch.models import model as M
    dev = devmod.resolve(spec.device)
    if spec.params_path:
        from repro_torch.training import checkpoint as ckpt
        return ckpt.restore(spec.params_path, device=dev)["params"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(spec.seed)
    return M.init_params(cfg, gen)


def build_engine(spec: EngineSpec, *, cfg=None, params=None,
                 store=_UNSET):
    """Validated construction of an ``Engine`` from a spec.

    ``cfg``/``params``/``store`` override the corresponding spec fields
    when given (pass ``store=None`` explicitly for a storeless engine); a
    strategy declaring ``needs_store=False`` never takes a store."""
    from repro_torch.serving.engine import Engine
    spec.validate()
    if cfg is None:
        cfg = build_cfg(spec)
    if params is None:
        params = build_params(spec, cfg)
    if spec.mesh is not None:
        from repro_torch.distributed.sharding import serving_kv_shards
        # indivisible heads raise here, before a store (and its worker
        # thread) is built
        serving_kv_shards(spec.mesh, cfg)
    if store is _UNSET:
        store = build_store(spec.store) \
            if get_strategy(spec.strategy).needs_store else None
    return Engine(
        cfg, params, store,
        sched=spec.sched,
        pool_blocks=spec.pool_blocks, block_size=spec.block_size,
        decode_bucket_b=spec.decode_bucket_b,
        seq_bucket=spec.seq_bucket,
        strategy=spec.strategy,
        use_focus=spec.use_focus,
        force_recompute_fraction=spec.force_recompute_fraction,
        layerwise_load=spec.layerwise_load,
        store_fixed_variants=spec.store_fixed_variants,
        store_new_chunks=spec.store_new_chunks,
        fix_rpe=spec.fix_rpe, fix_causality=spec.fix_causality,
        time_scale=spec.time_scale,
        incremental_decode=spec.incremental_decode,
        share_chunk_kv=spec.share_chunk_kv,
        trace_decode=spec.trace_decode,
        attn_impl=spec.attn_impl, paged_decode=spec.paged_decode,
        mesh=spec.mesh, device=spec.device)
