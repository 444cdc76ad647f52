"""The port's training data pipeline against the JAX package's on the CPU:
the synthetic dataset and its split (equal, sample for sample), a Kaldi
directory that the test writes, and ``BucketBatcher``'s batches (features
within the frontend's 1e-4, integers equal, refs trimmed alike, drops
counted alike)."""

import numpy as np
import pytest

from test_torch_common import jax_config, jax_model, n

from speechcatcher_tpu_torch.config import tiny_config
from speechcatcher_tpu_torch.data import (
    BucketBatcher,
    read_kaldi_dir,
    synthetic_dataset,
    train_eval_split,
)
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params
from speechcatcher_tpu_torch.utils.audio import write_wav


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config(n_mels=20)
    tree = random_params(cfg, 0)
    return cfg, jax_model(cfg, tree), ASRModel.from_numpy(cfg, tree, "cpu")


def test_synthetic_dataset_and_split_equal_jax(models):
    from speechcatcher_tpu.data import synthetic_dataset as JS
    from speechcatcher_tpu.data import train_eval_split as JSplit

    cfg, jm, pm = models
    ref = JS(23, jax_config(cfg), jm.tokenizer, seed=5)
    got = synthetic_dataset(23, cfg, pm.tokenizer, seed=5)
    assert [(u.uttid, u.text) for u in got] == [(u.uttid, u.text)
                                                for u in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.wave, b.wave)
    for frac in (0.0, 0.1, 0.3):
        ids = [[u.uttid for u in part] for part in
               train_eval_split(got, frac, seed=2)]
        assert ids == [[u.uttid for u in part] for part in
                       JSplit(ref, frac, seed=2)]


def _kaldi_dir(root, tokenizer):
    """wav.scp + text: seven utterances of 0.4-3 s, one without a
    transcript, one whose text needs more frames than it has, one longer
    than the largest sample bucket the test uses."""
    rng = np.random.default_rng(3)
    words = [p.lstrip("▁") for p in tokenizer.token_list[2:-1]]
    scp, text = [], []
    for i, sec in enumerate((1.2, 0.4, 2.1, 0.9, 3.0, 1.5, 0.7)):
        path = root / f"u{i}.wav"
        write_wav(path, (rng.standard_normal(int(16000 * sec)) * 3000)
                  .astype(np.int16))
        scp.append(f"u{i} {path}")
        n_words = 40 if i == 1 else int(rng.integers(2, 6))
        if i != 5:
            text.append(f"u{i} " + " ".join(rng.choice(words, n_words)))
    (root / "wav.scp").write_text("\n".join(scp) + "\n")
    (root / "text").write_text("\n".join(text) + "\n")
    return root


@pytest.mark.parametrize("with_refs", [False, True])
def test_bucket_batcher_matches_jax(models, tmp_path, with_refs):
    from speechcatcher_tpu.data import BucketBatcher as JB
    from speechcatcher_tpu.data import read_kaldi_dir as JR

    cfg, jm, pm = models
    data = _kaldi_dir(tmp_path, pm.tokenizer)
    ref_utts = JR(data)
    utts = read_kaldi_dir(data)
    assert [(u.uttid, u.text) for u in utts] == [(u.uttid, u.text)
                                                 for u in ref_utts]
    assert len(utts) == 6
    for a, b in zip(utts, ref_utts):
        np.testing.assert_array_equal(a.wave, b.wave)
    assert len(read_kaldi_dir(data, limit=2)) == 2

    kw = dict(batch_size=2, sample_buckets=[16000, 32000],
              token_buckets=(4, 8))
    jb = JB(jm.frontend, jm.tokenizer, **kw)
    pb = BucketBatcher(pm.frontend, pm.tokenizer, **kw)
    ref = list(jb.batches(ref_utts, shuffle_seed=1, with_refs=with_refs))
    got = list(pb.batches(utts, shuffle_seed=1, with_refs=with_refs))
    assert pb.n_dropped == jb.n_dropped == 3  # u1 (targets), u2, u4 (long)
    assert len(got) == len(ref) >= 2
    for g, r in zip(got, ref):
        if with_refs:
            assert g[1] == r[1]
            g, r = g[0], r[0]
        np.testing.assert_allclose(n(g.feats), n(r.feats), rtol=1e-4,
                                   atol=1e-4)
        for field in ("feat_lens", "tokens", "token_lens"):
            np.testing.assert_array_equal(n(getattr(g, field)),
                                          n(getattr(r, field)))
    if with_refs:  # the flush batch pads a row and keeps one ref
        assert any(len(texts) < kw["batch_size"] for _, texts in got)


def test_subsampled_frames_match_jax(models):
    from speechcatcher_tpu.data import BucketBatcher as JB

    cfg, jm, pm = models
    for layer in ("conv2d", "conv2d6", "conv2d8", "linear"):
        jb = JB(jm.frontend, jm.tokenizer, input_layer=layer)
        pb = BucketBatcher(pm.frontend, pm.tokenizer, input_layer=layer)
        for samples in (400, 1600, 4000, 16001, 48000):
            assert pb._subsampled_frames(samples) == jb._subsampled_frames(
                samples)
