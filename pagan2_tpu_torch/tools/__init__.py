"""Measuring tools of the linear wavefront, run on the card by default:

    python -m pagan2_tpu_torch.tools.probe_linear    # kernel F, probe cases
    python -m pagan2_tpu_torch.tools.bisect_linear   # kernel F, bisect runs
    python -m pagan2_tpu_torch.tools.sweep_linear    # kernel A over B, N, TD
    python -m pagan2_tpu_torch.tools.bench_linear    # kernel A, B 8 x 4095 bp

Each prints ms per launch (CUDA events), microseconds per diagonal and
GCUPS per case, and its `main` returns the cases as dicts. `--device cpu
--small` runs the plain versions on the CPU at a small size, timed by
the host clock. Without a card the default `--device cuda` raises.
"""
