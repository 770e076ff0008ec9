"""PyTorch/CUDA port of the HCK system (the KRR fit and Algorithm-3 serving).

The JAX package ``repro`` is the reference; this package mirrors its module
layout with PyTorch inside.  Entry points run on the CUDA card unless the
caller asks for the CPU (:mod:`repro_torch.device`); on the card every
TPU kernel of the fit and serving paths is a hand-written CUDA C++ kernel
under ``repro_torch/csrc``, built with ``nvcc`` at first use.
"""
