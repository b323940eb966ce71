"""The benchmark of unetseg_tpu_torch (see BENCHMARK.json and PERF.md)."""
