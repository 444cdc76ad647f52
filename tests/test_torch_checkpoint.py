"""Checkpoint loading of the PyTorch port against the JAX package on the CPU.

The inverse of ``convert_state_dict`` (``chip_smoke.espnet_state_dict``, which
belongs to neither package) puts the leaves of a ``random_params`` tree under
ESPnet's key names (both spellings of the conv stack, ``embed.conv.N`` and
``embed.N``; both of the embed output and of the conformer's BatchNorm), and
one dict of numpy arrays goes to both packages' converters: the same leaves,
exactly. A model directory written here (``chip_smoke.write_model_dir``:
``exp/<run>/valid.acc.ave_6best.pth`` saved as ``{"model": sd}``, a
``config.yaml``, ``asr_stats_*/train/feats_stats.npz`` in the
sum/sum_square/count form) loads through both ``ASRModel.from_directory``s
and decodes alike through both sessions.
"""

import tarfile
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import espnet_state_dict, write_model_dir
from test_torch_common import synth_audio
from test_torch_conformer import _perturb
from test_torch_streaming import _run

import speechcatcher_tpu.checkpoint as J
import speechcatcher_tpu_torch.checkpoint as P
from speechcatcher_tpu.models.asr_model import ASRModel as JaxModel
from speechcatcher_tpu.streaming import Speech2TextStreaming as JaxSession
from speechcatcher_tpu_torch.config import ModelConfig, tiny_config
from speechcatcher_tpu_torch.models.asr_model import ASRModel
from speechcatcher_tpu_torch.params import random_params, tree_leaves
from speechcatcher_tpu_torch.streaming import (
    Speech2TextStreaming,
    create_streaming_interface,
)
from speechcatcher_tpu_torch.tokenizer import find_bpe_model
from speechcatcher_tpu_torch.utils.zoo import _find_model_dir, _unpack

INPUT_LAYERS = ("conv2d", "conv2d6", "conv2d8", "linear")
ENCODERS = ("transformer", "conformer")


def _config(input_layer: str, encoder_type: str) -> ModelConfig:
    return tiny_config(input_layer=input_layer, encoder_type=encoder_type,
                       conformer_kernel_size=7)


def _tree(cfg, seed=5):
    tree = random_params(cfg, seed)
    if cfg.encoder_type == "conformer":
        _perturb(tree, seed)
    # Biases and norms that are not all zeros and ones.
    rng = np.random.default_rng(seed)
    for path, leaf in tree_leaves(tree):
        if path.endswith("bias") or "norm" in path:
            leaf += rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
    return tree


def _assert_same_leaves(got, ref):
    got, ref = dict(tree_leaves(got)), dict(tree_leaves(ref))
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        a, b = np.asarray(got[path]), np.asarray(leaf)
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("spelling", ["conv-out-norm", "bare-out0-batch_norm"])
@pytest.mark.parametrize("encoder_type", ENCODERS)
@pytest.mark.parametrize("input_layer", INPUT_LAYERS)
def test_convert_state_dict_matches_jax(input_layer, encoder_type, spelling):
    cfg = _config(input_layer, encoder_type)
    tree = _tree(cfg)
    conv, out, bn = spelling.split("-")
    sd = espnet_state_dict(tree, cfg, conv, out.replace("out0", "out.0"), bn)
    from test_torch_common import jax_config

    got = P.convert_state_dict(sd, cfg)
    ref = J.convert_state_dict(sd, jax_config(cfg))
    _assert_same_leaves(got, ref)
    _assert_same_leaves(got, tree)          # and the round trip is exact
    assert all(isinstance(leaf, np.ndarray) for _, leaf in tree_leaves(got))
    assert P.infer_architecture(sd) == J.infer_architecture(sd)
    arch = P.infer_architecture(sd)
    assert (arch["encoder_layers"], arch["decoder_layers"],
            arch["encoder_dim"], arch["vocab_size"],
            arch["ctc_vocab_size"]) == (
        cfg.encoder_layers, cfg.decoder_layers, cfg.encoder_dim,
        cfg.vocab_size, cfg.vocab_size)
    # The tree is what the model constructor takes.
    model = ASRModel.from_numpy(cfg, got, device="cpu")
    assert len(model.params["encoder"]["layers"]) == cfg.encoder_layers


def test_conformer_is_detected_from_the_keys():
    """A transformer config over conformer keys converts as a conformer."""
    cfg = _config("conv2d", "conformer")
    sd = espnet_state_dict(_tree(cfg), cfg)
    got = P.convert_state_dict(sd, cfg.replace(encoder_type="transformer"))
    assert "conv_module" in got["encoder"]["layers"]


# ---------------------------------------------------------------------------
# A model directory
# ---------------------------------------------------------------------------

def _espnet_config(cfg: ModelConfig) -> dict:
    conf = {
        "encoder": ("contextual_block_conformer"
                    if cfg.encoder_type != "transformer"
                    else "contextual_block_transformer"),
        "encoder_conf": {
            "output_size": cfg.encoder_dim,
            "attention_heads": cfg.encoder_heads,
            "linear_units": cfg.encoder_linear_units,
            "num_blocks": cfg.encoder_layers,
            "input_layer": cfg.input_layer,
            "block_size": cfg.block_size,
            "hop_size": cfg.hop_size,
            "look_ahead": cfg.look_ahead,
            "init_average": True,
            "ctx_pos_enc": True,
        },
        "decoder_conf": {
            "attention_heads": cfg.decoder_heads,
            "linear_units": cfg.decoder_linear_units,
            "num_blocks": cfg.decoder_layers,
        },
        "frontend_conf": {"n_fft": cfg.n_fft, "hop_length": cfg.hop_length,
                          "win_length": cfg.win_length},
        "token_list": [f"t{i}" for i in range(cfg.vocab_size)],
    }
    if cfg.encoder_type == "contextual_block_conformer":
        conf["encoder_conf"].update(macaron_style=cfg.macaron_style,
                                    cnn_module_kernel=cfg.conformer_kernel_size,
                                    activation_type=cfg.activation_type)
    return conf


# Without a config.yaml the architecture is inferred from shapes over the
# default config: heads stay at its 4, so the widths must divide by 4.
DIR_CFG = tiny_config(encoder_heads=4, decoder_heads=4, block_size=40,
                      hop_size=16, look_ahead=16)


@pytest.fixture(scope="module", params=["config", "no_config"])
def model_dir(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("espnet_" + request.param)
    tree = _tree(DIR_CFG, seed=11)
    tree["decoder"]["output_layer"]["bias"][DIR_CFG.eos_id] += 4.0
    tree["ctc"]["ctc_lo"]["bias"][DIR_CFG.blank_id] += 3.0
    run = write_model_dir(
        root, DIR_CFG, tree,
        config=_espnet_config(DIR_CFG) if request.param == "config" else None)
    return run, tree, request.param == "config"


def test_from_directory_matches_jax(model_dir):
    run, tree, with_config = model_dir
    pm = ASRModel.from_directory(run, device="cpu")
    jm = JaxModel.from_directory(run)
    from test_torch_common import shared_fields

    assert shared_fields(pm.cfg) == shared_fields(jm.cfg)
    if with_config:
        assert pm.cfg == DIR_CFG.replace(max_enc_frames=2048, max_tokens=500)
    else:   # inferred over the defaults
        assert pm.cfg == ModelConfig(
            vocab_size=DIR_CFG.vocab_size, encoder_dim=DIR_CFG.encoder_dim,
            decoder_dim=DIR_CFG.decoder_dim,
            encoder_layers=DIR_CFG.encoder_layers,
            decoder_layers=DIR_CFG.decoder_layers,
            encoder_linear_units=DIR_CFG.encoder_linear_units,
            decoder_linear_units=DIR_CFG.decoder_linear_units)
    assert pm.device.type == "cpu"
    # The loaded weights: the layers are per-layer lists in the port.
    from test_torch_precision import _assert_trees_equal

    _assert_trees_equal(pm.params, jm.params)
    np.testing.assert_array_equal(
        pm.params["ctc"]["ctc_lo"]["weight"].numpy(),
        tree["ctc"]["ctc_lo"]["weight"])
    # The stats (sum / sum_square / count form) reached the frontend.
    feats = np.random.default_rng(1).standard_normal((9, 80)).astype(
        np.float32)
    import jax.numpy as jnp

    np.testing.assert_allclose(
        pm.frontend.normalize_only(feats).numpy(),
        np.asarray(jm.frontend.normalize_only(jnp.asarray(feats))),
        rtol=1e-5, atol=1e-5)
    assert not np.allclose(pm.frontend.normalize_only(feats).numpy()[0],
                           feats)
    # No bpe.model: the dummy tokenizer.
    assert pm.tokenizer.token_list == jm.tokenizer.token_list
    assert pm.tokenizer.vocab_size == DIR_CFG.vocab_size


def test_sessions_over_a_model_directory_decode_alike(model_dir):
    run, _, _ = model_dir
    js = JaxSession(model_dir=run, beam_size=3)
    ps = Speech2TextStreaming(model_dir=run, beam_size=3, device="cpu")
    made = create_streaming_interface(run, beam_size=3, device="cpu")
    assert made.model.device.type == "cpu" and made.beam_size == 3
    audio = synth_audio(3.0, 11)
    chunks = [audio[i:i + 8000] for i in range(0, len(audio), 8000)]
    j_out, j_nbest = _run(js, chunks)
    for session in (ps, made):
        p_out, p_nbest = _run(session, chunks)
        assert p_out == j_out
        for (jy, jx, jsc), (py, px, psc) in zip(j_nbest, p_nbest):
            np.testing.assert_array_equal(py, jy)
            np.testing.assert_array_equal(px, jx)
            np.testing.assert_allclose(psc, jsc, rtol=1e-4)
    assert len(j_nbest[0][0]) > 2


def test_session_over_a_model_directory_in_a_precision_mode(model_dir):
    run, _, _ = model_dir
    js = JaxSession(model_dir=run, beam_size=3, dtype="int8-all")
    ps = Speech2TextStreaming(model_dir=run, beam_size=3, device="cpu",
                              dtype="int8-all")
    assert ps.model.params["ctc"]["ctc_lo"]["weight"].dtype == torch.int8
    audio = synth_audio(2.0, 12)
    assert [r[2:] for r in ps.recognize(audio)] == \
        [r[2:] for r in js.recognize(audio)]


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for call in (lambda: ASRModel.from_directory(tmp_path),
                 lambda: Speech2TextStreaming(model_dir=tmp_path),
                 lambda: create_streaming_interface(tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        ASRModel.from_directory(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="model_dir or model"):
        Speech2TextStreaming(device="cpu")


@pytest.mark.parametrize("wrap", ["model", "state_dict", "bare"])
def test_load_espnet_checkpoint_matches_jax(tmp_path, wrap):
    """The three checkpoint layouts; the shape-inference overrides and the
    conformer detection over a default config."""
    cfg = _config("conv2d", "conformer")
    tree = _tree(cfg)
    run = write_model_dir(tmp_path, cfg, tree, wrap=wrap)
    ckpt = run / "valid.acc.ave_6best.pth"
    params, got_cfg, arch = P.load_espnet_checkpoint(ckpt)
    j_params, j_cfg, j_arch = J.load_espnet_checkpoint(ckpt)
    _assert_same_leaves(params, j_params)
    _assert_same_leaves(params, tree)
    from test_torch_common import shared_fields

    assert shared_fields(got_cfg) == shared_fields(j_cfg)
    assert arch == j_arch
    assert got_cfg.encoder_type == "conformer"
    assert (got_cfg.encoder_dim, got_cfg.decoder_dim, got_cfg.vocab_size) \
        == (cfg.encoder_dim, cfg.decoder_dim, cfg.vocab_size)
    # A given config is kept where the shapes agree with it.
    _, kept, _ = P.load_espnet_checkpoint(ckpt, cfg)
    assert kept == cfg


def test_find_checkpoint_priority_and_find_stats(tmp_path):
    names = ["valid.acc.best.pth", "valid.acc.ave_6best.pth",
             "valid.acc.ave.pth", "model.pth", "checkpoint.pth"]
    assert P.find_checkpoint(tmp_path) is None is J.find_checkpoint(tmp_path)
    run = tmp_path / "exp" / "run_a"
    run.mkdir(parents=True)
    (run / "model.pth").touch()
    # A run directory is searched after the model directory itself.
    assert P.find_checkpoint(tmp_path) == run / "model.pth"
    for name in reversed(names):
        (tmp_path / name).touch()
        assert P.find_checkpoint(tmp_path) == tmp_path / name \
            == J.find_checkpoint(tmp_path)

    assert P.find_stats(run) is None is J.find_stats(run)
    deep = run / "stats" / "feats_stats.npz"
    deep.parent.mkdir()
    deep.touch()
    assert P.find_stats(run) == deep == J.find_stats(run)
    sibling = tmp_path / "exp" / "asr_stats_raw" / "train" / "feats_stats.npz"
    sibling.parent.mkdir(parents=True)
    sibling.touch()
    assert P.find_stats(run) == sibling == J.find_stats(run)
    (run / "feats_stats.npz").touch()
    assert P.find_stats(run) == run / "feats_stats.npz" == J.find_stats(run)


def test_load_normalization_stats_both_formats(tmp_path):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((200, 80)) * 1.5 - 0.5
    np.savez(tmp_path / "a.npz", mean=feats.mean(0), std=feats.std(0))
    np.savez(tmp_path / "b.npz", sum=feats.sum(0),
             sum_square=(feats ** 2).sum(0), count=np.asarray(200))
    np.savez(tmp_path / "c.npz", other=feats.sum(0))
    for name in ("a.npz", "b.npz"):
        mean, std = P.load_normalization_stats(tmp_path / name)
        j_mean, j_std = J.load_normalization_stats(tmp_path / name)
        np.testing.assert_array_equal(mean, j_mean)
        np.testing.assert_array_equal(std, j_std)
        np.testing.assert_allclose(mean, feats.mean(0), rtol=1e-10)
        np.testing.assert_allclose(std, feats.std(0), rtol=1e-8)
    with pytest.raises(ValueError, match="Unknown stats format"):
        P.load_normalization_stats(tmp_path / "c.npz")


def _write_bpe_model(path: Path, pieces):
    """A SentencePiece ModelProto holding only the piece table."""
    def varint(v):
        out = bytearray()
        while True:
            out.append((v & 0x7F) | (0x80 if v > 0x7F else 0))
            v >>= 7
            if not v:
                return bytes(out)

    buf = bytearray()
    for piece in pieces:
        raw = piece.encode("utf-8")
        inner = b"\x0a" + varint(len(raw)) + raw
        buf += b"\x0a" + varint(len(inner)) + inner
    path.write_bytes(bytes(buf))


def test_from_directory_reads_a_bpe_model(tmp_path):
    run = write_model_dir(tmp_path, DIR_CFG, _tree(DIR_CFG, 2),
                          config=_espnet_config(DIR_CFG))
    assert find_bpe_model(run) is None
    pieces = ["<unk>", "<s>", "</s>"] + [
        f"▁w{i}" for i in range(DIR_CFG.vocab_size - 3)]
    _write_bpe_model(run / "bpe.model", pieces)
    assert find_bpe_model(run) == run / "bpe.model"
    pm = ASRModel.from_directory(run, device="cpu")
    jm = JaxModel.from_directory(run)
    assert pm.tokenizer.token_list == jm.tokenizer.token_list
    assert pm.tokenizer.token_list[:3] == ["<blank>", "<unk>", "▁w0"]
    assert pm.tokenizer.vocab_size == DIR_CFG.vocab_size


# ---------------------------------------------------------------------------
# Packed archives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["zip", "tar"])
@pytest.mark.parametrize("meta", [False, True], ids=["search", "meta"])
def test_unpack_and_find_model_dir(tmp_path, kind, meta):
    import speechcatcher_tpu.utils.zoo as JZ

    src = tmp_path / "src"
    run = write_model_dir(src, DIR_CFG, _tree(DIR_CFG, 2),
                          config=_espnet_config(DIR_CFG))
    if meta:
        with open(src / "meta.yaml", "w") as f:
            yaml.safe_dump({"files": {"asr_model_file": str(
                (run / "valid.acc.ave_6best.pth").relative_to(src))},
                "yaml_files": {"asr_train_config": str(
                    (run / "config.yaml").relative_to(src))}}, f)
    files = sorted(p for p in src.rglob("*") if p.is_file())
    if kind == "zip":
        archive = tmp_path / "pack.zip"
        with zipfile.ZipFile(archive, "w") as z:
            for p in files:
                z.write(p, str(p.relative_to(src)))
    else:
        archive = tmp_path / "pack.tar.gz"
        with tarfile.open(archive, "w:gz") as tf:
            for p in files:
                tf.add(p, str(p.relative_to(src)))
    dest = _unpack(archive, tmp_path / "dest")
    assert (dest / ".unpacked").exists()
    found = _find_model_dir(dest)
    assert found == dest / run.relative_to(src) == JZ._find_model_dir(dest)
    # A second call finds the marker and unpacks nothing again.
    (found / "valid.acc.ave_6best.pth").unlink()
    _unpack(archive, dest)
    assert not (found / "valid.acc.ave_6best.pth").exists()
    assert _find_model_dir(tmp_path / "nothing_here") is None


def test_unpack_refuses_an_unknown_format(tmp_path):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not an archive")
    with pytest.raises(ValueError, match="Unknown archive format"):
        _unpack(junk, tmp_path / "dest")


# ---------------------------------------------------------------------------
# ESPnet's contextual-block conformer
# ---------------------------------------------------------------------------

CB = "contextual_block_conformer"


@pytest.mark.parametrize("macaron", [True, False])
def test_a_tree_without_linear_pos_converts_to_espnets_conformer(tmp_path,
                                                                 macaron):
    """ESPnet's layer names, ``conv_module.norm`` for the BatchNorm and no
    ``linear_pos``: the kind, the macaron flag and the taps come from the
    keys and shapes over the default config, and every leaf is kept."""
    cfg = tiny_config(encoder_type=CB, macaron_style=macaron,
                      conformer_kernel_size=5)
    tree = _tree(cfg)
    sd = espnet_state_dict(tree, cfg)
    assert not any("linear_pos" in k or "pos_bias" in k for k in sd)
    assert "encoder.encoders.0.conv_module.norm.running_var" in sd
    assert any("feed_forward_macaron" in k for k in sd) == macaron
    run = write_model_dir(tmp_path, cfg, tree)
    params, got, _ = P.load_espnet_checkpoint(run / "valid.acc.ave_6best.pth")
    assert (got.encoder_type, got.macaron_style, got.conformer_kernel_size) \
        == (CB, macaron, 5)
    _assert_same_leaves(params, tree)
    # With its config.yaml the directory loads as the same model.
    run = write_model_dir(tmp_path / "with_config", cfg, tree,
                          config=_espnet_config(cfg))
    pm = ASRModel.from_directory(run, device="cpu")
    assert pm.cfg == cfg.replace(max_enc_frames=2048, max_tokens=500)


def test_a_relative_attention_tree_stays_the_ports_conformer(tmp_path):
    """``linear_pos`` in the keys: the port's conformer, though the
    config.yaml names ESPnet's ``contextual_block_conformer``."""
    cfg = DIR_CFG.replace(encoder_type="conformer", conformer_kernel_size=7)
    tree = _tree(cfg)
    conf = _espnet_config(cfg)
    assert conf["encoder"] == CB
    assert ModelConfig.from_espnet_dict(conf).encoder_type == CB
    run = write_model_dir(tmp_path, cfg, tree, config=conf)
    pm = ASRModel.from_directory(run, device="cpu")
    assert pm.cfg.encoder_type == "conformer"
    assert "linear_pos" in pm.params["encoder"]["layers"][0]["self_attn"]


def test_a_relative_attention_yaml_keeps_the_jax_defaults(tmp_path):
    """A config.yaml with neither frontend_conf nor macaron_style over a
    ``linear_pos`` tree: the port's conformer takes the JAX package's
    defaults (window 400, hop 160), not the DefaultFrontend defaults that
    ESPnet's layer gets under the same encoder name."""
    from test_torch_common import PORT_ONLY, shared_fields

    cfg = DIR_CFG.replace(encoder_type="conformer")
    conf = _espnet_config(cfg)
    del conf["frontend_conf"]
    assert conf["encoder"] == CB
    run = write_model_dir(tmp_path, cfg, _tree(cfg), config=conf)
    pm = ASRModel.from_directory(run, device="cpu")
    jm = JaxModel.from_directory(run)
    assert shared_fields(pm.cfg) == shared_fields(jm.cfg)
    assert (pm.cfg.win_length, pm.cfg.hop_length) == (400, 160)
    for k in PORT_ONLY:
        assert getattr(pm.cfg, k) == getattr(ModelConfig, k), k


# The AISHELL-1 streaming-conformer recipe's values, as the benchmark's
# ``aishell-cb-conformer`` configuration assumes them; no frontend_conf, so
# ESPnet's DefaultFrontend defaults.
RECIPE = {
    "encoder": CB,
    "encoder_conf": {"output_size": 256, "attention_heads": 4,
                     "linear_units": 2048, "num_blocks": 12,
                     "dropout_rate": 0.1, "positional_dropout_rate": 0.1,
                     "attention_dropout_rate": 0.0, "input_layer": "conv2d",
                     "normalize_before": True, "activation_type": "swish",
                     "macaron_style": True, "use_cnn_module": True,
                     "cnn_module_kernel": 15, "block_size": 40,
                     "hop_size": 16, "look_ahead": 16, "init_average": True,
                     "ctx_pos_enc": True},
    "decoder": "transformer",
    "decoder_conf": {"attention_heads": 4, "linear_units": 2048,
                     "num_blocks": 6, "dropout_rate": 0.1},
    "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1},
    "token_list": ["<blank>", "<unk>"] + [f"c{i}" for i in range(4230)]
                  + ["<sos/eos>"],
}


def test_the_recipe_gives_the_benchmarks_configuration():
    import dataclasses
    import json

    model = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                        / "configs" / "aishell-cb-conformer.json")
                       .read_text())["model"]
    cfg = ModelConfig.from_espnet_dict(RECIPE, max_enc_frames=768,
                                       max_tokens=192)
    got = dataclasses.asdict(cfg)
    # The configuration names no LM: its keys are at "none".
    assert {k: got.pop(k) for k in LM_KEYS} == {
        k: getattr(ModelConfig, k) for k in LM_KEYS}
    assert got == model


LM_KEYS = ("lm_layers", "lm_dim", "lm_heads", "lm_linear_units",
           "lm_embed_dim", "lm_weight")
# The recipe's Transformer LM (its lm_conf), as the benchmark's
# ``aishell-cb-conformer-lm`` assumes it, and the decode config's weight.
LM_RECIPE = {"lm": "transformer",
             "lm_conf": {"pos_enc": None, "embed_unit": 128, "att_unit": 512,
                         "head": 8, "unit": 2048, "layer": 16,
                         "dropout_rate": 0.1},
             "lm_weight": 0.3}


def test_the_recipe_with_its_lm_gives_the_benchmarks_configuration():
    import dataclasses
    import json

    model = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                        / "configs" / "aishell-cb-conformer-lm.json")
                       .read_text())["model"]
    cfg = ModelConfig.from_espnet_dict(RECIPE | LM_RECIPE,
                                       max_enc_frames=768, max_tokens=192)
    assert dataclasses.asdict(cfg) == model


@pytest.mark.parametrize("key,value", [("lm", "seq_rnn"),
                                       ("pos_enc", "sinusoidal")])
def test_an_lm_the_port_does_not_compute_is_refused(key, value):
    conf = RECIPE | LM_RECIPE
    if key == "lm":
        conf = conf | {"lm": value}
    else:
        conf = conf | {"lm_conf": dict(LM_RECIPE["lm_conf"], pos_enc=value)}
    with pytest.raises(ValueError, match=key):
        ModelConfig.from_espnet_dict(conf)


@pytest.mark.parametrize("key,value", [("use_cnn_module", False),
                                       ("activation_type", "relu")])
def test_what_the_port_does_not_compute_is_refused(key, value):
    conf = dict(RECIPE, encoder_conf=dict(RECIPE["encoder_conf"],
                                          **{key: value}))
    with pytest.raises(ValueError, match=key):
        ModelConfig.from_espnet_dict(conf)


def test_an_unknown_encoder_kind_is_refused():
    with pytest.raises(ValueError, match="encoder_type"):
        tiny_config(encoder_type="branchformer")
    with pytest.raises(ValueError, match="activation_type"):
        tiny_config(encoder_type=CB, activation_type="relu")
