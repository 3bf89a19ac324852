"""The benchmark harness of agrep_tpu_torch: inputs, runs, references
and metrics (see benchmark/run.py)."""
