"""Device ops: the kernels' wrappers and plain versions (``attention``,
``window_attention``, ``augpipe``), the DCT-domain ops (``photometric``,
``blocks``, ``geometry``, ``fastdct``), the JPEG tail decode
(``pixel_decode``), the kernel build (``cuda_build``) and the numpy DCT
basis matrices (``basis``)."""
