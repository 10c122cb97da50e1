"""Device ops: the kernels' wrappers and plain versions (``attention``,
``augpipe``), the DCT-domain ops (``photometric``, ``blocks``), the kernel
build (``cuda_build``) and the numpy DCT basis matrices (``basis``)."""
