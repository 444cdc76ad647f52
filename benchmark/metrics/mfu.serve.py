"""Model FLOPs that the window's decoded audio needs (``benchmark.roofline.
model_flops``: subsampling, the encoder's blocks, the CTC head and the
cross-attention K/V a frame; the beam steps of the streams that stepped, as
the beam loops counted them), over the window's seconds, as a share of the
H100's float32 peak."""

from benchmark.metrics._common import serve_mfu as read  # noqa: F401
