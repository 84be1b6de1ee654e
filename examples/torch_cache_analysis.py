"""The paper's §2.3/§3 analyses of ``examples/cache_analysis.py`` on the
PyTorch port:

 * contextualization grows with prefix length (Fig. 7),
 * inter vs intra attention distributions decide reusability (Figs. 9/10),
 * output deviation falls as recompute rises (Fig. 15),
 * CCI correlates with deviation (Fig. 12).

Run on the GPU:  python examples/torch_cache_analysis.py
Run on the host: python examples/torch_cache_analysis.py --device cpu

``run(cfg, params, device)`` does the work on given weights and returns
the printed figures as a dict.
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
from repro_torch.core import scoring                           # noqa
from repro_torch.core.chunkstore import ChunkStore             # noqa
from repro_torch.core.prefill import CacheCraftExecutor        # noqa
from repro_torch.core.tiers import TieredStore                 # noqa
from repro_torch.models import model as M                      # noqa
from repro_torch.serving.metrics import relative_deviation     # noqa

FRACTIONS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


@torch.no_grad()
def _forward(cfg, params, device, seq, cids=None):
    """One train-mode forward of ``seq`` (no gradient is taken, so no
    autograd graph is kept)."""
    tokens = torch.as_tensor(seq[None], device=device)
    if cids is None:
        return M.forward(cfg, params, tokens=tokens, mode="train")
    return M.forward(cfg, params, tokens=tokens, mode="train",
                     chunk_ids=torch.as_tensor(cids[None], device=device),
                     collect_stats=True)


def run(cfg, params, device) -> dict:
    """The three analyses on ``params`` (on ``device``): prints their
    lines and returns Fig. 7's deviations by prefix count, each chunk's
    a_bar / b_bar / CCI and Fig. 15's deviation by recompute fraction."""
    device = devmod.resolve(device)
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    chunks = [rng.integers(0, V, 24) for _ in range(6)]

    # --- Fig. 7: contextualization vs number of prefix chunks -------------
    print("Fig.7 — hidden-state deviation of chunk C vs #prefix chunks:")
    C = chunks[0]
    h_alone = _forward(cfg, params, device, C).hidden[0].cpu().numpy()
    fig7 = []
    for n_prefix in (0, 1, 2, 3):
        seq = np.concatenate(chunks[1:1 + n_prefix] + [C])
        out = _forward(cfg, params, device, seq)
        h_c = out.hidden[0, -len(C):].cpu().numpy()
        dev = np.linalg.norm(h_c - h_alone) / np.linalg.norm(h_alone)
        fig7.append(float(dev))
        print(f"  prefix={n_prefix}: deviation {dev:.3f}")

    # --- Figs. 9/10 + Eq. 9-11: inter/intra -> CCI -------------------------
    print("\nEq.9-11 — inter/intra attention and CCI per chunk:")
    seq = np.concatenate(chunks[:4])
    cids = np.repeat(np.arange(4), [len(c) for c in chunks[:4]])
    out = _forward(cfg, params, device, seq, cids)
    stats = out.stats[:, 0].cpu().numpy()
    inter = scoring.inter_matrix(stats, cids, 4)
    lengths = [len(c) for c in chunks[:4]]
    cci = []
    for i in range(1, 4):
        sc = scoring.chunk_scores(inter, lengths, i,
                                  [f"h{j}" for j in range(i)],
                                  np.zeros(lengths[i]))
        cci.append(dict(chunk=i, a_bar=float(sc.a_bar),
                        b_bar=float(sc.b_bar), cci=float(sc.cci)))
        print(f"  chunk {i}: a_bar={sc.a_bar:.4f} b_bar={sc.b_bar:.4f} "
              f"CCI={sc.cci:.3f}")

    # --- Fig. 15: deviation vs recompute fraction --------------------------
    print("\nFig.15 — output deviation vs recompute fraction:")
    fig15 = []
    with tempfile.TemporaryDirectory(prefix="cc-analysis-") as tmp:
        store = ChunkStore(TieredStore(1 << 30, 1 << 30, tmp), 100, 5)
        try:
            sys_t = rng.integers(0, V, 8)
            q1, q2 = rng.integers(0, V, 12), rng.integers(0, V, 12)
            CacheCraftExecutor(cfg, params, store, use_focus=False,
                               device=device).process(sys_t, chunks[:3], q1)
            oracle = CacheCraftExecutor(
                cfg, params, None, strategy="all", device=device).process(
                sys_t, [chunks[1], chunks[0], chunks[3]], q2)
            for frac in FRACTIONS:
                ex = CacheCraftExecutor(cfg, params, store, use_focus=False,
                                        force_recompute_fraction=frac,
                                        store_fixed_variants=False,
                                        store_new_chunks=False,
                                        device=device)
                r = ex.process(sys_t, [chunks[1], chunks[0], chunks[3]], q2)
                dev = relative_deviation(r.logits_last, oracle.logits_last)
                fig15.append(dict(fraction=frac, deviation=float(dev)))
                print(f"  recompute {frac:.0%}: deviation {dev:.4f}")
        finally:
            store.tiers.close()
    return dict(fig7=fig7, chunks=cci, fig15=fig15)


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
