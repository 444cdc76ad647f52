"""The plain reference against the port's CPU route at tiny_config: the
same encoder frames as the port's session, the same score for the
hypothesis the port's beam search served, every served token within its
prefix's top beam; and the control (the reference with its products'
operands in TF32) away from it."""

import numpy as np
import pytest
import torch

from benchmark.harness import check, weights
from benchmark.harness.traffic import speech_like
from benchmark.reference import asr
from conftest import tiny_model


def session_final(m, tree, pcm, chunk=8192, beam=3):
    from speechcatcher_tpu_torch.config import ModelConfig
    from speechcatcher_tpu_torch.models.asr_model import ASRModel
    from speechcatcher_tpu_torch.streaming import Speech2TextStreaming

    model = ASRModel.from_numpy(ModelConfig(**m), weights.to_numpy(tree),
                                device="cpu")
    s2t = Speech2TextStreaming(model=model, beam_size=beam, device="cpu")
    chunks = check.chunks_of(pcm, len(pcm) % chunk, chunk)
    for i, c in enumerate(chunks):
        s2t.feed(c, is_final=i == len(chunks) - 1)
    bs = s2t.beam_search
    yseq, xpos, score = bs.best_hypothesis()
    frames = bs.chunk.ring[0, :bs.chunk.enc_len].clone()
    return chunks, yseq, xpos, score, frames


@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
@pytest.mark.parametrize("seconds,seed", [(1.3, 3), (3.3, 4_100_000_001),
                                          (5.0, 77)])
def test_reference_matches_the_port(encoder_type, seconds, seed):
    m = tiny_model(encoder_type=encoder_type)
    tree = weights.make_tree(m, {"eos": 2.0, "blank": 8.0}, seed, "cpu",
                             asr.weight_specs)
    pcm = speech_like(seconds, np.random.default_rng(seed), 16000)
    chunks, yseq, xpos, score, frames = session_final(m, tree, pcm)
    ref = asr.Reference(m, tree, "cpu")
    enc = ref.encode(chunks)
    assert enc.shape == frames.shape
    assert torch.allclose(enc, frames, atol=2e-5, rtol=1e-5)
    r = ref.rescore(enc, ref.ctc_logp(enc), yseq, xpos, 3)
    assert len(yseq) > 2
    assert abs(r.score - score) < 1e-4
    assert r.token_gaps.max() < 1e-4


def test_the_control_reads_lower_precision():
    m = tiny_model()
    tree = weights.make_tree(m, {"eos": 2.0, "blank": 8.0}, 5, "cpu",
                             asr.weight_specs)
    pcm = speech_like(4.0, np.random.default_rng(5), 16000)
    chunks, yseq, xpos, score, _ = session_final(m, tree, pcm)
    ref = asr.Reference(m, tree, "cpu")
    enc = ref.encode(chunks)
    f32 = ref.rescore(enc, ref.ctc_logp(enc), yseq, xpos, 3).score
    with asr.in_tf32():
        enc_r = ref.encode(chunks)
        low = ref.rescore(enc_r, ref.ctc_logp(enc_r), yseq, xpos, 3).score
    # The port's gap to the reference is float32 rounding (1e-5); the
    # control's is TF32's, far above it.
    assert abs(low - f32) > 10 * abs(score - f32)
    assert abs(low - f32) > 1e-4


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0])
    with asr.in_tf32():
        y = asr._r(x)
    assert y.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]
    assert asr._r(x) is x


def test_chunks_follow_the_wire():
    pcm = np.arange(-10, 20000, dtype=np.int16)
    chunks = check.chunks_of(pcm, len(pcm) - 16384, 8192)
    assert [len(c) for c in chunks] == [8192, 8192, len(pcm) - 16384]
    assert chunks[0][0] == np.float32(-10) / np.float32(32767)
    assert chunks[-1][0] == np.float32(16374) * np.float32(1 / 32767)
    assert check.chunks_of(pcm, 5, 8192) is None
