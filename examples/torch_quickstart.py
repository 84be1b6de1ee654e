"""Quickstart on the PyTorch port: the Cache-Craft loop of
``examples/quickstart.py`` on ``repro_torch``.

1. Build a tiny model + knowledge base.
2. Serve a question (cold): every chunk computed, caches captured.
3. Serve a *different* question reusing two of the chunks in a new
   order: Cache-Craft reuses their KV (RoPE re-applied by the ``rope``
   kernel on the GPU), recomputes only the CFO-selected tokens, and is
   compared with full recompute and with naive reuse.

Run on the GPU:  python examples/torch_quickstart.py
Run on the host: python examples/torch_quickstart.py --device cpu

``run(cfg, params, device)`` does the work on given weights (the tests
feed it the JAX example's, ``chip_smoke.py`` full-width llama3-8b's) and
returns the printed figures as a dict.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np                                             # noqa
import torch                                                   # noqa

from repro_torch import device as devmod                       # noqa
from repro_torch.configs import get_tiny                       # noqa
from repro_torch.core.chunkstore import ChunkStore             # noqa
from repro_torch.core.prefill import CacheCraftExecutor        # noqa
from repro_torch.core.tiers import TieredStore                 # noqa
from repro_torch.models import model as M                      # noqa
from repro_torch.serving.metrics import relative_deviation     # noqa


def run(cfg, params, device) -> dict:
    """The quickstart on ``params`` (on ``device``): prints its lines and
    returns request 1's computed / total tokens and stored variants,
    request 2's hits, tokens and per-segment decisions, and the two
    last-token logit deviations from full recompute."""
    rng = np.random.default_rng(0)
    V = cfg.vocab_size

    system = rng.integers(0, V, 8)
    chunk_a = rng.integers(0, V, 24)
    chunk_b = rng.integers(0, V, 24)
    chunk_c = rng.integers(0, V, 24)
    question1 = rng.integers(0, V, 12)
    question2 = rng.integers(0, V, 12)

    with tempfile.TemporaryDirectory(prefix="cc-quickstart-") as tmp:
        store = ChunkStore(TieredStore(1 << 30, 1 << 30, tmp),
                           n_chunks=100, m_variants=5)
        try:
            cc = CacheCraftExecutor(cfg, params, store,
                                    store_fixed_variants=False,
                                    device=device)

            print("-> request 1 (cold): [sys][A][B][q1]")
            r1 = cc.process(system, [chunk_a, chunk_b], question1)
            variants = store.num_variants()
            print(f"   computed {r1.plan.num_active_tokens}/{r1.total_len} "
                  f"tokens, {variants} chunk-caches stored")

            print("-> request 2 (warm): [sys][B][A][C][q2]  "
                  "(B,A reused, reordered)")
            r2 = cc.process(system, [chunk_b, chunk_a, chunk_c], question2)
            hits = sum(d.is_hit for d in r2.plan.decisions)
            print(f"   cache hits {hits}/4 segments; computed "
                  f"{r2.plan.num_active_tokens}/{r2.total_len} tokens "
                  f"({r2.compute_fraction:.0%} of full prefill FLOPs)")
            for d in r2.plan.decisions:
                tag = "hit " if d.is_hit else "miss"
                print(f"   seg{d.seg.stat_id}: {tag} CFO={d.cfo:.2f} "
                      f"recompute {len(d.recompute_idx)}/{d.seg.length} "
                      "tokens")

            oracle = CacheCraftExecutor(cfg, params, None, strategy="all",
                                        device=device)
            ro = oracle.process(system, [chunk_b, chunk_a, chunk_c],
                                question2)
            naive = CacheCraftExecutor(cfg, params, store, strategy="none",
                                       store_fixed_variants=False,
                                       store_new_chunks=False, device=device)
            rn = naive.process(system, [chunk_b, chunk_a, chunk_c],
                               question2)
        finally:
            store.tiers.close()
    dev_naive = relative_deviation(rn.logits_last, ro.logits_last)
    dev_cc = relative_deviation(r2.logits_last, ro.logits_last)
    print("-> last-token logit deviation vs full recompute:")
    print(f"   naive reuse (Full-Cache): {dev_naive:.3f}")
    print(f"   Cache-Craft:              {dev_cc:.3f}")
    return dict(
        r1_computed=int(r1.plan.num_active_tokens), r1_total=r1.total_len,
        variants=variants, hits=int(hits),
        r2_computed=int(r2.plan.num_active_tokens), r2_total=r2.total_len,
        compute_fraction=float(r2.compute_fraction),
        segments=[dict(stat_id=int(d.seg.stat_id), hit=bool(d.is_hit),
                       cfo=float(d.cfo), length=int(d.seg.length),
                       recompute_idx=[int(i) for i in d.recompute_idx])
                  for d in r2.plan.decisions],
        dev_naive=float(dev_naive), dev_cachecraft=float(dev_cc))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)
    cfg = get_tiny("llama3-8b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    run(cfg, M.init_params(cfg, gen), dev)


if __name__ == "__main__":
    main()
