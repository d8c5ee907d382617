"""PyTorch/CUDA port of the hybrid IVF-Flat filtered search (``repro``).

Mirrors ``repro``'s module paths: ``repro_torch.core.<m>`` is the
counterpart of ``repro.core.<m>`` and ``repro_torch.kernels.<k>`` of
``repro.kernels.<k>``.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper takes its
plain PyTorch version.
"""
