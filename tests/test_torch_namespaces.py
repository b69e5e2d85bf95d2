"""The port's package namespaces hold every name the JAX package exports from the same path, once ported.

For each JAX namespace (the top level, ``functional``, ``core`` and every
domain package beside them), each exported name whose defining module has a
port counterpart, and whose object that counterpart holds, must be
importable from the port's namespace of the same path. The one exception is
``functional.classification.precision_recall_curve``: there the port keeps
the module as the package attribute (its dispatcher lives inside it).
"""

import importlib
import pkgutil
import types

import pytest

import torchmetrics_tpu  # noqa: F401  (the JAX package: imported first, on the CPU by conftest)

ALLOWED = {("torchmetrics_tpu.functional.classification", "precision_recall_curve")}
NAMESPACES = [
    "torchmetrics_tpu",
    "torchmetrics_tpu.audio",
    "torchmetrics_tpu.classification",
    "torchmetrics_tpu.clustering",
    "torchmetrics_tpu.core",
    "torchmetrics_tpu.detection",
    "torchmetrics_tpu.functional",
    "torchmetrics_tpu.functional.audio",
    "torchmetrics_tpu.functional.classification",
    "torchmetrics_tpu.functional.clustering",
    "torchmetrics_tpu.functional.detection",
    "torchmetrics_tpu.functional.image",
    "torchmetrics_tpu.functional.multimodal",
    "torchmetrics_tpu.functional.nominal",
    "torchmetrics_tpu.functional.pairwise",
    "torchmetrics_tpu.functional.regression",
    "torchmetrics_tpu.functional.retrieval",
    "torchmetrics_tpu.functional.segmentation",
    "torchmetrics_tpu.functional.text",
    "torchmetrics_tpu.image",
    "torchmetrics_tpu.multimodal",
    "torchmetrics_tpu.nominal",
    "torchmetrics_tpu.parallel",
    "torchmetrics_tpu.regression",
    "torchmetrics_tpu.retrieval",
    "torchmetrics_tpu.segmentation",
    "torchmetrics_tpu.sketches",
    "torchmetrics_tpu.text",
    "torchmetrics_tpu.utilities",
    "torchmetrics_tpu.wrappers",
]


def _port(name: str):
    """The port's module of a JAX module path, or None where it is not ported."""
    try:
        return importlib.import_module("torchmetrics_tpu_torch" + name[len("torchmetrics_tpu"):])
    except ImportError:
        return None


def _exported(module) -> list:
    names = getattr(module, "__all__", None)
    return list(names) if names is not None else [n for n in vars(module) if not n.startswith("_")]


def _ported_names(path: str) -> list:
    """The names ``path`` exports whose defining module, and the object in it, are ported."""
    module, out = importlib.import_module(path), []
    for name in _exported(module):
        obj = getattr(module, name, None)
        if obj is None:
            continue
        home = obj.__name__ if isinstance(obj, types.ModuleType) else getattr(obj, "__module__", None)
        if not isinstance(home, str) or not home.startswith("torchmetrics_tpu."):
            continue
        port_home = _port(home)
        if port_home is None:
            continue
        if not isinstance(obj, types.ModuleType) and not hasattr(port_home, getattr(obj, "__name__", name)):
            continue
        out.append(name)
    return out


def test_every_ported_domain_package_is_walked():
    """The list above covers every subpackage of the JAX package and of its ``functional`` that the port has."""
    found = set()
    for base in ("torchmetrics_tpu", "torchmetrics_tpu.functional"):
        for info in pkgutil.iter_modules(importlib.import_module(base).__path__):
            path = f"{base}.{info.name}"
            if info.ispkg and _port(path) is not None:
                found.add(path)
    assert found <= set(NAMESPACES), sorted(found - set(NAMESPACES))


@pytest.mark.parametrize("path", NAMESPACES)
def test_port_namespace_holds_every_ported_export(path):
    port = _port(path)
    assert port is not None, f"{path} has no port counterpart"
    names = _ported_names(path)
    missing = [n for n in names if (path, n) not in ALLOWED and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
    for name in names:  # what the port's namespace binds under a ported name is the ported object
        if (path, name) in ALLOWED:
            continue
        want = getattr(importlib.import_module(path), name)
        got = getattr(port, name)
        if isinstance(want, types.ModuleType):
            assert isinstance(got, types.ModuleType), (path, name)
        else:
            assert getattr(got, "__name__", None) == getattr(want, "__name__", None), (path, name)


def test_functional_exports_named_in_the_acceptance():
    import torchmetrics_tpu_torch as tm
    import torchmetrics_tpu_torch.core as core
    import torchmetrics_tpu_torch.functional as F
    import torchmetrics_tpu_torch.functional.classification as FC

    for name in ("accuracy", "binary_auroc", "mean_squared_error", "retrieval_precision",
                 "structural_similarity_index_measure", "rouge_score", "precision_recall_curve"):
        assert callable(getattr(F, name)), name
    assert isinstance(FC.precision_recall_curve, types.ModuleType)  # the module, kept
    assert {tm.MeanAveragePrecision.__name__, tm.ROUGEScore.__name__, tm.Reduce.__name__} == {
        "MeanAveragePrecision", "ROUGEScore", "Reduce"}
    assert (core.Metric, core.CompositionalMetric, core.Reduce) == (tm.Metric, tm.CompositionalMetric, tm.Reduce)


TEXT_FUNCTIONS = ("bert_score", "bleu_score", "char_error_rate", "chrf_score", "edit_distance",
                  "extended_edit_distance", "infolm", "match_error_rate", "perplexity", "rouge_score",
                  "sacre_bleu_score", "squad", "translation_edit_rate", "word_error_rate", "word_information_lost",
                  "word_information_preserved")
TEXT_CLASSES = ("BERTScore", "BLEUScore", "CharErrorRate", "CHRFScore", "DistinctNGrams", "EditDistance",
                "ExtendedEditDistance", "InfoLM", "MatchErrorRate", "Perplexity", "ROUGEScore", "SacreBLEUScore",
                "SQuAD", "TranslationEditRate", "WordErrorRate", "WordInfoLost", "WordInfoPreserved")


@pytest.mark.parametrize("kind", ["functions", "classes"])
def test_text_slice_is_exported_everywhere(kind):
    """Every text name of the JAX package, from the domain namespace and the top level, in both packages."""
    import torchmetrics_tpu_torch as tm
    import torchmetrics_tpu_torch.functional as F
    import torchmetrics_tpu_torch.functional.text as FT
    import torchmetrics_tpu_torch.text as T

    names, spaces = (TEXT_FUNCTIONS, (F, FT)) if kind == "functions" else (TEXT_CLASSES, (tm, T))
    jax_spaces = [importlib.import_module(s.__name__.replace("torchmetrics_tpu_torch", "torchmetrics_tpu"))
                  for s in spaces]
    for name in names:
        for space, jax_space in zip(spaces, jax_spaces):
            # the top levels leave DistinctNGrams to ``text``, in both packages
            assert (name in space.__all__) == hasattr(jax_space, name), (space.__name__, name)
            if hasattr(jax_space, name):
                assert getattr(space, name).__name__ == getattr(jax_space, name).__name__


DETECTION_FUNCTIONS = ("complete_intersection_over_union", "distance_intersection_over_union",
                       "generalized_intersection_over_union", "intersection_over_union", "modified_panoptic_quality",
                       "panoptic_quality")
DETECTION_CLASSES = ("CompleteIntersectionOverUnion", "DistanceIntersectionOverUnion",
                     "GeneralizedIntersectionOverUnion", "IntersectionOverUnion", "MeanAveragePrecision",
                     "ModifiedPanopticQuality", "PanopticQuality")
GENERATIVE_CLASSES = ("DeterministicFeatureExtractor", "FrechetInceptionDistance", "InceptionScore",
                      "KernelInceptionDistance", "LearnedPerceptualImagePatchSimilarity",
                      "MemorizationInformedFrechetInceptionDistance", "PerceptualPathLength")


@pytest.mark.parametrize(("names", "spaces"), [
    (DETECTION_FUNCTIONS, ("functional", "functional.detection")),
    (DETECTION_CLASSES, ("", "detection")),
    (GENERATIVE_CLASSES, ("", "image")),
    (("learned_perceptual_image_patch_similarity",), ("functional", "functional.image")),
], ids=["detection functions", "detection classes", "generative classes", "lpips function"])
def test_detection_and_generative_slice_is_exported_everywhere(names, spaces):
    """Every detection and generative image name, from its domain namespace and the top levels, in both packages
    alike: where the JAX namespace exports it, the port's does, the same object by name."""
    for space in spaces:
        port = importlib.import_module("torchmetrics_tpu_torch" + (f".{space}" if space else ""))
        jax_space = importlib.import_module("torchmetrics_tpu" + (f".{space}" if space else ""))
        for name in names:
            exported = name in jax_space.__all__ if hasattr(jax_space, "__all__") else hasattr(jax_space, name)
            assert (name in port.__all__) == exported, (space, name)
            if hasattr(jax_space, name):
                assert getattr(port, name).__name__ == getattr(jax_space, name).__name__, (space, name)


def test_parallel_exports_of_the_sync_engineering_slice():
    """``torchmetrics_tpu.parallel``'s names that the port holds since the sync-engineering slice; JAX's
    ``SyncAdvisor`` and ``SyncAutotuner`` (and its helpers) wait for the observability and compile slices, and
    ``metric_mesh`` has no counterpart (the port syncs one rank a device over the default process group)."""
    import torchmetrics_tpu.parallel as jpar
    import torchmetrics_tpu_torch.parallel as tpar

    ported = {"CompressionConfig", "CompressionSpec", "DeferredRaggedSync", "SyncPolicy", "SyncStepper",
              "apply_sync_plan", "bucketed_collective_count", "build_sync_plan", "cadence_stepper",
              "coalesced_host_sync", "coalesced_metric_sync", "coalesced_sync_state", "distributed_available",
              "flush_sync", "gather_all_arrays", "per_leaf_collective_count", "reduce_op",
              "sharded_collection_update", "sharded_list_update", "sharded_update", "sync_ragged_states", "sync_state"}
    waiting = {"SyncAdvisor", "SyncAutotuner", "committed_policy", "policy_dict"}
    waiting |= {"metric_mesh"}  # no counterpart
    assert set(jpar.__all__) == ported | waiting
    assert ported <= set(tpar.__all__) and not waiting & set(tpar.__all__)
    for name in ported:
        assert getattr(tpar, name).__name__ == getattr(jpar, name).__name__, name
