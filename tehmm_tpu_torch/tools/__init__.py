"""Measurement tools of the port, run as ``python -m
tehmm_tpu_torch.tools.<name>``: ``bench_engines`` (E-step and decode
engines side by side), ``profile_estep`` (the stages of the
``cuda_v3`` E-step), ``time_scans`` (the scan tile's kernels alone) and
``exp_maxplus_s256`` (K9: two layouts of a max-plus step whose matrix
does not fit in a block's fast memory)."""
