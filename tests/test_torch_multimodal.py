"""The port's multimodal metrics (CLIPScore, CLIP-IQA, their CLIP backbone and stand-ins), held against the JAX
package's.

Both packages load one tiny random-initialised CLIP checkpoint from a temp directory: the JAX package through
``FlaxCLIPModel(from_pt=True)``, the port through torch's ``CLIPModel``; both run the same tokenizer and the same
host image processor. The stand-in image encoder runs on the JAX draws, carried by
``convert.clip_image_encoder_from_jax``. Tolerances: the CLIP features within 1e-5 of their largest magnitude
(float32 transformers of XLA and ATen on the CPU), CLIPScore within 1e-4 absolute on its 0-100 scale, the CLIP-IQA
probabilities within 1e-5 absolute; the stand-in encoders within 1e-6 of their largest magnitude (one float32
convolution), their scores within 1e-4 and 1e-5 as above.
"""

from __future__ import annotations

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.multimodal.clip_iqa as jiqa
import torchmetrics_tpu.multimodal as jmm
from torchmetrics_tpu.multimodal.backbones.clip import load_clip_encoders as jload
import torchmetrics_tpu_torch.functional.multimodal.clip_iqa as tiqa
import torchmetrics_tpu_torch.multimodal as tmm
from torchmetrics_tpu_torch import convert
from torchmetrics_tpu_torch.multimodal.backbones.clip import load_clip_encoders as tload

# the packages export ``clip_score`` the function under the module's name
jcs = importlib.import_module("torchmetrics_tpu.functional.multimodal.clip_score")
tcs = importlib.import_module("torchmetrics_tpu_torch.functional.multimodal.clip_score")
CPU = torch.device("cpu")
FEATURE_TOL = 1e-5
SCORE_TOL = 1e-4
PROB_TOL = 1e-5
CAPTIONS = ["a photo of a cat", "a red car, parked.", "a good dog!"]
LONG_CAPTION = " ".join(["a very long caption"] * 12)  # 85 characters and more: past 77 tokens


@pytest.fixture(scope="module")
def tiny_clip_dir(tmp_path_factory):
    """A tiny random-init ``CLIPModel``, a character-level CLIP BPE vocabulary (letters, digits and punctuation,
    each with its ``</w>`` form, no merges) and a ``CLIPImageProcessor`` at 32 x 32, with the text config's
    ``bos_token_id``/``eos_token_id`` pinned to the vocabulary's: CLIP's text pooling reads the end-of-text
    position."""
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPTokenizer

    d = tmp_path_factory.mktemp("tiny_clip")
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for c in sorted("abcdefghijklmnopqrstuvwxyz0123456789.,!?'"):
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt"), model_max_length=77).save_pretrained(str(d))
    CLIPImageProcessor(size={"shortest_edge": 32}, crop_size={"height": 32, "width": 32}).save_pretrained(str(d))
    cfg = CLIPConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77, bos_token_id=0, eos_token_id=1),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                           image_size=32, patch_size=8),
        projection_dim=16,
    )
    torch.manual_seed(0)
    CLIPModel(cfg).eval().save_pretrained(str(d))
    return str(d)


def _images(seed, n=2, hw=(40, 48)):
    return np.random.default_rng(seed).integers(0, 255, (n, 3, *hw)).astype(np.float32)


def _close_to_scale(got, want, tol, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, err_msg
    np.testing.assert_array_less(np.abs(got - want), tol * np.abs(want).max() + 1e-30, err_msg=err_msg)


# ------------------------------------------------------------------ the CLIP backbone
def test_clip_encoders_against_jax(tiny_clip_dir):
    j_img, j_txt = jload(tiny_clip_dir)
    t_img, t_txt = tload(tiny_clip_dir, "cpu")
    assert tload(tiny_clip_dir, CPU) == (t_img, t_txt)  # cached per (path, device)
    assert t_img.model.training is False and t_img.device == CPU
    for hw in ((40, 48), (57, 31)):
        imgs = _images(hw[0], hw=hw)
        got, want = t_img(torch.from_numpy(imgs)), np.asarray(j_img(jnp.asarray(imgs)))
        assert got.dtype == torch.float32 and not got.requires_grad
        _close_to_scale(got.numpy(), want, FEATURE_TOL, f"image features at {hw}")
    got, want = t_txt(CAPTIONS[:2]), np.asarray(j_txt(CAPTIONS[:2]))
    _close_to_scale(got.numpy(), want, FEATURE_TOL, "text features")
    assert np.linalg.norm(want[0] - want[1]) > 0.1  # distinct captions pool distinct positions


def test_long_caption_truncates_with_the_warning(tiny_clip_dir):
    j_txt, t_txt = jload(tiny_clip_dir)[1], tload(tiny_clip_dir, "cpu")[1]
    with pytest.warns(UserWarning, match="max_position_embeddings=77"):
        want = np.asarray(j_txt([LONG_CAPTION, CAPTIONS[0]]))
    with pytest.warns(UserWarning, match="max_position_embeddings=77"):
        got = t_txt([LONG_CAPTION, CAPTIONS[0]])
    _close_to_scale(got.numpy(), want, FEATURE_TOL)


# ------------------------------------------------------------------ CLIPScore
def test_clip_score_functional_against_jax(tiny_clip_dir):
    imgs = _images(1)
    want = float(jcs.clip_score([jnp.asarray(i) for i in imgs], CAPTIONS[1:], model_name_or_path=tiny_clip_dir))
    got = tcs.clip_score([torch.from_numpy(i) for i in imgs], CAPTIONS[1:], model_name_or_path=tiny_clip_dir)
    assert got.dtype == torch.float32 and got.device == CPU and got.ndim == 0
    assert abs(float(got) - want) <= SCORE_TOL
    # a (B, 3, H, W) tensor, and a single (3, H, W) image with one caption: the first pair's score
    pairs, n = tcs._clip_score_update(torch.from_numpy(imgs), CAPTIONS[1:], *tload(tiny_clip_dir, "cpu"), CPU)
    assert n == 2 and pairs.shape == (2,) and abs(float(pairs.mean().clamp_min(0)) - float(got)) <= 1e-5
    for images in (torch.from_numpy(imgs[:1]), torch.from_numpy(imgs[0])):
        single = float(tcs.clip_score(images, CAPTIONS[1], model_name_or_path=tiny_clip_dir))
        assert abs(single - max(float(pairs[0]), 0.0)) <= 1e-4


def test_clip_score_class_two_updates_against_jax(tiny_clip_dir):
    imgs = _images(2, n=4)
    captions = CAPTIONS + [LONG_CAPTION[:60]]
    jm = jmm.CLIPScore(model_name_or_path=tiny_clip_dir)
    tm = tmm.CLIPScore(model_name_or_path=tiny_clip_dir, device="cpu")
    assert tm.full_state_update is False
    for sl in (slice(0, 2), slice(2, 4)):
        jm.update([jnp.asarray(i) for i in imgs[sl]], captions[sl])
        tm.update([torch.from_numpy(i) for i in imgs[sl]], captions[sl])
    for key in ("score", "n_samples"):
        got, want = tm.metric_state[key], np.asarray(jm.metric_state[key])
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= SCORE_TOL * (4 if key == "score" else 0) + 1e-6, key
    assert abs(float(tm.compute()) - float(jm.compute())) <= SCORE_TOL
    # forward: the batch's value (the same pairs as the first update), the state merged
    batch = float(tm(torch.from_numpy(imgs[:2]), captions[:2]))
    assert abs(batch - float(jcs.clip_score(jnp.asarray(imgs[:2]), captions[:2],
                                            model_name_or_path=tiny_clip_dir))) <= SCORE_TOL
    assert float(tm.metric_state["n_samples"]) == 6.0


def test_clip_score_clamps_the_mean_not_each_pair():
    """Scores of +60 and -100: the mean 0 -> clamped to 0 only if negative, and each pair is kept signed."""
    image_encoder = lambda imgs: torch.stack([torch.tensor([1.0, 0.0]), torch.tensor([1.0, 0.0])])  # noqa: E731
    text_encoder = lambda rows: torch.tensor([[0.6, 0.8], [-1.0, 0.0]])  # noqa: E731
    m = tmm.CLIPScore(image_encoder=image_encoder, text_encoder=text_encoder, device="cpu")
    m.update(torch.zeros((2, 3, 4, 4)), ["a", "b"])
    assert abs(float(m.metric_state["score"]) - (-40.0)) < 1e-4
    assert float(m.compute()) == 0.0
    m.update(torch.zeros((2, 3, 4, 4)), ["a", "b"])
    m.metric_state["score"] += 200.0
    assert abs(float(m.compute()) - 30.0) < 1e-4


# ------------------------------------------------------------------ CLIP-IQA
@pytest.mark.parametrize("prompts", [("quality",), ("quality", "brightness"), (("Super photo.", "Terrible photo."),)])
def test_clip_iqa_functional_against_jax(tiny_clip_dir, prompts):
    imgs = _images(7, hw=(32, 32))
    kw = dict(model_name_or_path=tiny_clip_dir, data_range=255.0, prompts=prompts)
    want = jiqa.clip_image_quality_assessment(jnp.asarray(imgs), **kw)
    got = tiqa.clip_image_quality_assessment(torch.from_numpy(imgs), **kw)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == (2,)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=PROB_TOL, err_msg=k)
    else:
        assert tuple(got.shape) == tuple(np.shape(want)) == (2,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROB_TOL)


def test_clip_iqa_single_image_squeezes_to_a_scalar(tiny_clip_dir):
    imgs = _images(8, n=1, hw=(32, 32)) / 255.0
    want = jiqa.clip_image_quality_assessment(jnp.asarray(imgs), model_name_or_path=tiny_clip_dir)
    got = tiqa.clip_image_quality_assessment(torch.from_numpy(imgs), model_name_or_path=tiny_clip_dir)
    assert got.shape == () == np.shape(want)
    assert abs(float(got) - float(want)) <= PROB_TOL
    probs = tiqa._clip_iqa_compute(torch.eye(4)[:2], torch.eye(4), ["a", "b"], format_as_dict=False)
    assert probs.shape == (2, 2)  # the (N, P) tensor


@pytest.mark.parametrize("prompts", [("quality",), ("quality", "natural"), ("sharpness", ("Crisp.", "Soft."))])
def test_clip_iqa_class_two_updates_against_jax(tiny_clip_dir, prompts):
    imgs = _images(3, n=4, hw=(36, 32))
    kw = dict(model_name_or_path=tiny_clip_dir, data_range=255.0, prompts=prompts)
    jm, tm = jmm.CLIPImageQualityAssessment(**kw), tmm.CLIPImageQualityAssessment(**kw, device="cpu")
    _close_to_scale(tm.anchors.numpy(), np.asarray(jm.anchors), FEATURE_TOL, "anchors")
    for sl in (slice(0, 2), slice(2, 4)):
        jm.update(jnp.asarray(imgs[sl]))
        tm.update(torch.from_numpy(imgs[sl]))
    feats = tm.metric_state["img_features"]
    assert isinstance(feats, tuple) and len(feats) == 2 and feats[0].shape == (2, 16)
    want, got = jm.compute(), tm.compute()
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=PROB_TOL, err_msg=k)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROB_TOL)


def test_clip_iqa_every_keyword_and_a_custom_pair_with_the_stand_ins():
    """All sixteen keywords and a custom pair at once, on the stand-in encoders (the JAX draws carried)."""
    j_img = jcs.DeterministicImageEncoder()
    t_img = convert.clip_image_encoder_from_jax(np.asarray(j_img.w1), np.asarray(j_img.proj), device="cpu")
    prompts = (*tiqa._PROMPTS, ("Crisp photo.", "Soft photo."))
    assert tuple(tiqa._PROMPTS) == tuple(jiqa._PROMPTS) and tiqa._PROMPTS == jiqa._PROMPTS
    imgs = np.random.default_rng(9).uniform(size=(5, 3, 20, 21)).astype(np.float32)
    want = jiqa.clip_image_quality_assessment(jnp.asarray(imgs), prompts=prompts, image_encoder=j_img,
                                              text_encoder=jcs.DeterministicTextEncoder())
    got = tiqa.clip_image_quality_assessment(torch.from_numpy(imgs), prompts=prompts, image_encoder=t_img,
                                             text_encoder=tcs.DeterministicTextEncoder(device="cpu"))
    assert list(got) == list(want) and len(got) == 17 and "user_defined_0" in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=PROB_TOL, err_msg=k)


# ------------------------------------------------------------------ the stand-in encoders
@pytest.mark.parametrize("hw", [(16, 16), (15, 17), (7, 8), (1, 1)])
@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_stand_in_image_encoder_on_carried_weights(hw, scale):
    """Even and odd sides: XLA's ``"SAME"`` padding at stride 2 puts the odd pixel of padding at the end."""
    j_img = jcs.DeterministicImageEncoder()
    t_img = convert.clip_image_encoder_from_jax(np.asarray(j_img.w1), np.asarray(j_img.proj), device="cpu")
    assert isinstance(t_img, torch.nn.Module) and t_img.w1.shape == (16, 3, 3, 3) and t_img.proj.shape == (16, 64)
    imgs = (np.random.default_rng(hw[0]).uniform(size=(3, 3, *hw)) * scale).astype(np.float32)
    _close_to_scale(t_img(torch.from_numpy(imgs)).numpy(), np.asarray(j_img(jnp.asarray(imgs))), 1e-6)


def test_stand_in_scale_predicate_is_one_over_the_batch():
    """One image above 1.5 divides the whole batch by 255, as ``jnp.where(x.max() > 1.5, ...)`` does."""
    j_img = jcs.DeterministicImageEncoder()
    t_img = convert.clip_image_encoder_from_jax(np.asarray(j_img.w1), np.asarray(j_img.proj), device="cpu")
    imgs = np.random.default_rng(0).uniform(size=(2, 3, 8, 8)).astype(np.float32)
    imgs[1] *= 255.0
    got, want = t_img(torch.from_numpy(imgs)).numpy(), np.asarray(j_img(jnp.asarray(imgs)))
    _close_to_scale(got, want, 1e-6)
    alone = t_img(torch.from_numpy(imgs[:1])).numpy()
    assert np.abs(alone - got[:1]).max() > 1e-3  # alone, the first image is not divided


def test_stand_in_text_encoder_against_jax():
    texts = ["A photo of a CAT", "", "two dogs running on the beach at dawn " * 20, "naïve café"]
    got = tcs.DeterministicTextEncoder(device="cpu")(texts)
    want = np.asarray(jcs.DeterministicTextEncoder()(texts))
    assert got.dtype == torch.float32 and got.shape == (4, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_default_stand_ins_warn_and_score_against_jax():
    """A hub id that is not in the local cache: both packages warn and fall back to their stand-ins; on carried
    weights the scores agree."""
    imgs = _images(4, n=2, hw=(24, 24))
    with pytest.warns(UserWarning, match="not available locally"):
        tcs._resolve_clip_encoders("no-such/clip-checkpoint", device="cpu")
    with pytest.warns(UserWarning, match="not available locally"):
        jcs._resolve_clip_encoders("no-such/clip-checkpoint")
    t_img, t_txt = tcs._resolve_clip_encoders("no-such/clip-checkpoint", device="cpu")
    assert isinstance(t_img, tcs.DeterministicImageEncoder) and isinstance(t_txt, tcs.DeterministicTextEncoder)
    j_img = jcs.DeterministicImageEncoder()
    carried = convert.clip_image_encoder_from_jax(np.asarray(j_img.w1), np.asarray(j_img.proj), device="cpu")
    want = float(jcs.clip_score(jnp.asarray(imgs), CAPTIONS[:2], image_encoder=j_img,
                                text_encoder=jcs.DeterministicTextEncoder()))
    got = tcs.clip_score(torch.from_numpy(imgs), CAPTIONS[:2], image_encoder=carried, text_encoder=t_txt)
    assert abs(float(got) - want) <= SCORE_TOL


# ------------------------------------------------------------------ every ValueError path
def _both_raise(j_call, t_call, match):
    with pytest.raises(ValueError, match=match):
        j_call()
    with pytest.raises(ValueError, match=match):
        t_call()


def test_clip_score_value_errors():
    enc = dict(image_encoder=lambda x: x.mean((2, 3)), text_encoder=lambda t: torch.ones((len(t), 3)))
    jenc = dict(image_encoder=lambda x: x.mean((2, 3)), text_encoder=lambda t: jnp.ones((len(t), 3)))
    img = np.zeros((3, 8, 8), np.float32)
    _both_raise(lambda: jcs.clip_score([jnp.asarray(img)], ["a", "b"], **jenc),
                lambda: tcs.clip_score([torch.from_numpy(img)], ["a", "b"], **enc), "the same")
    _both_raise(lambda: jcs.clip_score([jnp.zeros((1, 3, 8, 8))], ["a"], **jenc),
                lambda: tcs.clip_score([torch.zeros((1, 3, 8, 8))], ["a"], **enc), "3d")
    _both_raise(lambda: jcs.clip_score(jnp.zeros((2, 1, 3, 8, 8)), ["a", "b"], **jenc),
                lambda: tcs.clip_score(torch.zeros((2, 1, 3, 8, 8)), ["a", "b"], **enc), "3d")
    m = tmm.CLIPScore(device="cpu", **enc)
    with pytest.raises(ValueError, match="the same"):
        m.update(torch.zeros((2, 3, 8, 8)), ["a"])


@pytest.mark.parametrize(("prompts", "match"), [
    (["quality"], "must be a tuple"),
    (("quality", 3), "must be a tuple"),
    (("bogus_keyword",), "must be one of"),
    ((("a", "b", "c"),), "length 2"),
])
def test_clip_iqa_prompt_value_errors(prompts, match):
    _both_raise(lambda: jiqa._clip_iqa_format_prompts(prompts), lambda: tiqa._clip_iqa_format_prompts(prompts), match)
    enc = dict(image_encoder=lambda x: x.mean((2, 3)), text_encoder=lambda t: torch.ones((len(t), 3)))
    with pytest.raises(ValueError, match=match):
        tmm.CLIPImageQualityAssessment(prompts=prompts, device="cpu", **enc)
    with pytest.raises(ValueError, match=match):
        tiqa.clip_image_quality_assessment(torch.zeros((1, 3, 4, 4)), prompts=prompts, **enc)


def test_clip_iqa_range_and_shape_value_errors():
    enc = dict(image_encoder=lambda x: x.mean((2, 3)), text_encoder=lambda t: torch.ones((len(t), 3)))
    jenc = dict(image_encoder=lambda x: x.mean((2, 3)), text_encoder=lambda t: jnp.ones((len(t), 3)))
    for bad in (0, -1.0, "255", None):
        _both_raise(lambda: jiqa.clip_image_quality_assessment(jnp.zeros((1, 3, 4, 4)), data_range=bad, **jenc),
                    lambda: tiqa.clip_image_quality_assessment(torch.zeros((1, 3, 4, 4)), data_range=bad, **enc),
                    "positive number")
        with pytest.raises(ValueError, match="positive number"):
            tmm.CLIPImageQualityAssessment(data_range=bad, device="cpu", **enc)
    for shape in ((3, 4, 4), (1, 1, 4, 4), (1, 4, 4, 4)):
        _both_raise(lambda: jiqa.clip_image_quality_assessment(jnp.zeros(shape), **jenc),
                    lambda: tiqa.clip_image_quality_assessment(torch.zeros(shape), **enc), "Expected 4D")
        m = tmm.CLIPImageQualityAssessment(device="cpu", **enc)
        with pytest.raises(ValueError, match="Expected 4D"):
            m.update(torch.zeros(shape))
