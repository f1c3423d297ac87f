"""tehmm_tpu_torch — the PyTorch/CUDA port of ``tehmm_tpu``.

A second package beside the JAX one, held against it by the tests.  It
runs supervised and Baum-Welch EM training and the Viterbi-eval -> BED
path end to end on an NVIDIA Hopper card, with the E-step's and the
decode's TPU kernels rewritten by hand in CUDA C++ (``csrc/em_estep.cu``,
``csrc/viterbi.cu``).  Module names mirror ``tehmm_tpu`` so each
counterpart is easy to find:

  - ``models``    — ``HmmParams`` (three tensors), emissions,
                    ``MultitrackHmm`` (``fit``, ``fit_restarts``)
  - ``ops``       — plain-torch DP (``dp``), E-step, M-step and EM loops
                    (``em``) and the CUDA kernels with their wrappers
                    (``cuda_kernels``)
  - ``parallel``  — chunk planning and halo-stitched / exact decoding
  - ``cli``       — ``train`` (EM, priors, ``--supervised``) and
                    ``eval --bed``
  - ``utils``     — explicit device resolution

The host layer (``tehmm_tpu.io``, ``tehmm_tpu.native``,
``tehmm_tpu.utils.common``) imports no JAX and is shared as it is.  This
package imports ``torch`` and never ``jax``.
"""
