"""Device ops: the attention kernel's wrapper (``attention``), the kernel
build (``cuda_build``) and the numpy DCT basis matrices (``basis``)."""
