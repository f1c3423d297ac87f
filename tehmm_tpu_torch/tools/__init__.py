"""Measurement tools of the port, run as ``python -m
tehmm_tpu_torch.tools.<name>``: ``bench_engines`` (E-step and decode
engines side by side) and ``profile_estep`` (the stages of the
``cuda_v3`` E-step)."""
