"""The benchmark of ``repro_torch``, driven by data: a cell is a file under
``cells/`` naming a configuration under ``configs/``, a traffic mix under
``traffic/`` and its engine settings; each per-layer metric is a reader
under ``metrics/``. ``python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell and prints one JSON line."""
