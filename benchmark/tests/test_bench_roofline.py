"""The yardstick's arithmetic against hand counts at small shapes."""

from benchmark.roofline import kernels, model_flops, peaks
from conftest import tiny_model


def test_attention_kernels_count_each_operand_once():
    # n=2 windows, h=2 heads, w=4 frames, dk=3: q, k, v read and out
    # written (4 × 48 values) plus the 4 × 4 mask; two products of
    # 2·n·h·w·w·dk = 384 operations, three for the relative form, whose
    # position table (2·4·3) and two biases (2·3 each) are read once.
    assert kernels.block_attention(2, 2, 4, 3) == (832.0, 768.0)
    assert kernels.rel_block_attention(2, 2, 4, 3) == (976.0, 1152.0)


def test_ctc_recursion_counts_the_frames_recursed():
    # Stream 1: no token yet (olen 0), frames [1, 5): 4 frames, frame 0 of
    # the label rows read too; stream 2: olen 3, frames [3, 8): 5 frames.
    n_bytes, n_ops = kernels.ctc_recursion(2, 10, [0, 3], [5, 8])
    assert n_bytes == 340.0 + 304.0
    assert n_ops == 16 * 4 * 2 + 16 * 5 * 2


def test_ring_appends_move_the_rows_appended():
    assert kernels.ring_append_cols(5, [2, 3]) == (216.0, 0.0)
    assert kernels.ring_append_rows(4, [1, 2]) == (112.0, 0.0)
    assert kernels.ring_append_rows(4, [1, 2], in_bytes=4,
                                    out_bytes=2) == (3 * 4 * 6 + 16.0, 0.0)


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == 1.0
    assert peaks.bound_s(0, 67e12) == 1.0
    assert peaks.bound_s(3.35e12, 2 * 67e12) == 2.0


def test_model_flops_at_tiny_config():
    m = tiny_model()
    # conv1 2·9·16·39·2, conv2 2·9·16·16·19, linear 2·16·19·16.
    assert model_flops.subsample_flops_per_frame(m) == 22464 + 87552 + 9728
    # Per layer over a 10-row window: projections 4·2·10·16², attention
    # 2·2·10²·16, feed-forward 2·2·10·16·32; two layers.
    assert model_flops.encoder_block_flops(m) == 2 * (20480 + 6400 + 20480)
    # A block every 4 frames, the CTC head 2·16·32, K and V of 2 layers.
    assert model_flops.frame_flops(m) == 119744 + 94720 / 4 + 1024 + 2048
    # Per decoder layer 4·2·16² + 2·2·16·32 + 2·2·10·16; output 2·16·32.
    assert model_flops.decoder_row_flops(m, 10) == 2 * 4736 + 1024
    assert model_flops.frames_of_samples(m, 6400) == 10


def test_conformer_layers_count_their_extra_work():
    m = tiny_model(encoder_type="conformer")
    t = tiny_model()
    w, d, f, k = 10, 16, 32, m["conformer_kernel_size"]
    extra = (2 * (2 * w * d * f) + 2 * w * d * d + 2 * w * w * d
             + 2 * w * d * 2 * d + 2 * w * d * k + 2 * w * d * d)
    assert (model_flops.encoder_block_flops(m)
            == model_flops.encoder_block_flops(t) + 2 * extra)
