"""Cache-Craft core: chunk store, tiers, planner, scoring, focus,
preload and the partial-prefill executor."""
