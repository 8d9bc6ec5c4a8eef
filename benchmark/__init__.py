"""The PyTorch/CUDA port's benchmark: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell
of ``BENCHMARK.json`` once and prints one JSON line."""
