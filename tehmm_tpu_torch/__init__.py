"""tehmm_tpu_torch — the PyTorch/CUDA port of ``tehmm_tpu``.

A second package beside the JAX one, held against it by the tests.  It
runs supervised and Baum-Welch EM training, Viterbi and max-posterior
eval -> BED, posterior distributions and scoring, with categorical and
gaussian tracks, at base or segment resolution, end to end on an NVIDIA
Hopper card, with the TPU kernels of those paths rewritten by hand in
CUDA C++ (``csrc/``).  Module names mirror ``tehmm_tpu`` so each
counterpart is easy to find:

  - ``models``    — ``HmmParams`` (three tensors), emissions, gaussian
                    tracks (``gauss``), ``MultitrackHmm`` (``fit``,
                    ``fit_restarts``)
  - ``ops``       — plain-torch DP (``dp``), E-step, M-step and EM loops
                    (``em``) and the CUDA kernels with their wrappers
                    (``cuda_kernels``)
  - ``parallel``  — chunk planning and halo-stitched / exact decoding
  - ``io``        — tracks XML, BED, FASTA, BigWig, priors and segments
  - ``cli``       — ``train``, ``eval`` and ``segment_tracks``
  - ``utils``     — constants and logging (``common``), explicit device
                    resolution
  - ``native``    — the host C++ helpers (``tehmm_native.cpp``), built
                    with g++ into ``build/tehmm_tpu_torch/``

The host layer is the port's own copy of the JAX package's (``io``,
``native``, ``utils.common``): this package imports ``torch`` and never
``jax``, nor anything of ``tehmm_tpu``.
"""
