"""Tiny stand-ins of the cells for the CPU tests: the same harness, the
same traffic generator and engine settings, at widths a CPU runs in
seconds."""
TINY_MODEL = {"num_layers": 2, "d_model": 64, "num_heads": 4,
              "num_kv_heads": 2, "head_dim": 16, "d_ff": 64,
              "vocab_size": 512}
OPEN = {"rate_per_s": 4.0, "chunk_len": [16, 40], "sys_len": 8,
        "question_len": 8, "output_len": [4, 6], "warmup_requests": 4,
        "kb_chunks": 24}
CLOSED = {"clients": 4, "requests_per_client": 64, "chunk_len": [16, 40],
          "sys_len": 8, "question_len": 8, "output_len": [4, 10],
          "warmup_requests": 2, "kb_chunks": 24}
ENGINE = {"pool_blocks": 256,
          "store": {"hbm_bytes": 1 << 28, "cpu_bytes": 1 << 28,
                    "n_chunks": 64}}


# set from these tiny runs' own readings (served gap 0 to 0.04 without
# experts, 0.46 to 0.53 with four, where bf16 flips near-ties of the top-2
# routing; its mean 0.0002 to 0.011; stored KV 0.01 to 0.18) and their
# float8 control's (gap 0.66 to 1, mean 0.05, stored KV 0.19 to 0.42):
# the tests check the mechanism, the cells' own limits come from the card
LIMITS = {"served_gap": 0.3, "store_kv_err": 0.25}
MOE_LIMITS = {"served_gap": 1.0, "served_gap_mean": 0.03,
              "store_kv_err": 0.25}


def overrides(cell: str) -> dict:
    model = dict(TINY_MODEL)
    limits = LIMITS
    if cell == "granite-decode":
        model.update(num_experts=4, experts_per_token=2, d_ff=32)
        traffic = CLOSED
        limits = MOE_LIMITS
    else:
        traffic = OPEN
    return {"model": model, "traffic": traffic, "engine": ENGINE,
            "limits": limits}
