"""The port's surface held to ``tools/api_spec.json``.

For every ``paddle_tpu.*`` module of the spec that has a counterpart in
``paddle_tpu_torch`` (the same dotted path), the spec's module-level
names the port does not expose must equal the not-yet-ported list kept
here, one case a module.  A name that gets ported is taken off its list
in the same change, and a module that gets ported is added with its
list, so the lists shrink as the port grows.  The spec's dotted names
(members of classes, ``DataParallel.sublayers``) are held the same way,
one case a module, against ``DOTTED_KEPT``: a member the port lacks on
purpose, each with the test that holds the difference.  The test reads
the JSON file and imports only ``paddle_tpu_torch``."""
import importlib
import json
import os

import pytest

SPEC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "api_spec.json")

# module -> the spec's module-level names the port lacks
NOT_YET_PORTED = {
    "paddle_tpu": "",
    "paddle_tpu.amp": "",
    "paddle_tpu.distributed": "",
    "paddle_tpu.distributed.fleet": "",
    "paddle_tpu.distribution": "",
    "paddle_tpu.io": "",
    "paddle_tpu.jit": "",
    "paddle_tpu.inference": "",
    "paddle_tpu.nn": "",
    "paddle_tpu.nn.functional": "",
    "paddle_tpu.optimizer": "",
    "paddle_tpu.nn.initializer": "",
    "paddle_tpu.ops.pallas": "",
    "paddle_tpu.metric": "",
    "paddle_tpu.onnx": "",
    "paddle_tpu.optimizer.lr": "",
    "paddle_tpu.observability": "",
    "paddle_tpu.profiler": "",
    "paddle_tpu.quantization": "",
    "paddle_tpu.serving": "",
    "paddle_tpu.static": "",
    "paddle_tpu.text.datasets": "",
    "paddle_tpu.vision.datasets": "",
    "paddle_tpu.vision.ops": "",
    "paddle_tpu.vision.transforms": "",
    "paddle_tpu.utils": "",
}

# "module.Class.member" -> the test that holds why the port lacks it
DOTTED_KEPT = {}


# modules the spec does not list: the JAX package's public names (from
# its ``__init__``) and, second, those the port lacks
UNLISTED = {
    "paddle_tpu.vision": ("datasets models ops transforms", ""),
    "paddle_tpu.hapi": ("""
        Callback Checkpoint EarlyStopping LRScheduler Model
        ModelCheckpoint ProgBarLogger ReduceLROnPlateau VisualDL
        callbacks summary""", ""),
    "paddle_tpu.text": ("""
        Conll05st FastWordPieceTokenizer Imdb Imikolov Movielens
        UCIHousing WMT14 WMT16 datasets""", ""),
    "paddle_tpu.vision.models": ("""
        LeNet MobileNetV1 MobileNetV2 ResNet VGG mobilenet_v1 mobilenet_v2
        resnet18 resnet34 resnet50 resnet101 resnet152 vgg11 vgg13 vgg16
        vgg19""", ""),
    "paddle_tpu.parallel": ("""
        ColumnParallelLinear DataParallel LocalSGDTrainStep
        ParallelCrossEntropy Pipeline PipelineStage RowParallelLinear
        ShardedEmbedding SpmdTrainStep VocabParallelEmbedding
        get_placement pipeline_train_fn pipelined_fn recompute
        recompute_sequential reference_attention ring_attention
        ring_attention_per_device set_placement split
        stack_stage_params""", ""),
}


def _spec():
    with open(SPEC) as f:
        return json.load(f)


def _port(module):
    return "paddle_tpu_torch" + module[len("paddle_tpu"):]


def _has_counterpart(module):
    try:
        importlib.import_module(_port(module))
    except ModuleNotFoundError:
        return False
    return True


@pytest.mark.parametrize("module", sorted(NOT_YET_PORTED))
def test_missing_names_are_the_not_yet_ported_list(module):
    names = [n for n in _spec()[module] if "." not in n]
    port = importlib.import_module(_port(module))
    missing = sorted(n for n in names if not hasattr(port, n))
    assert missing == sorted(NOT_YET_PORTED[module].split())


def _lookup(obj, dotted):
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("module", sorted(NOT_YET_PORTED))
def test_missing_class_members_are_the_kept_list(module):
    port = importlib.import_module(_port(module))
    missing = sorted(f"{module}.{n}" for n in _spec()[module]
                     if "." in n and not _lookup(port, n))
    assert missing == sorted(k for k in DOTTED_KEPT
                             if k.rsplit(".", 2)[0] == module)


def test_every_ported_module_has_a_case():
    ported = sorted(m for m in _spec() if _has_counterpart(m))
    assert ported == sorted(NOT_YET_PORTED)


@pytest.mark.parametrize("module", sorted(UNLISTED))
def test_modules_outside_the_spec_lack_only_their_list(module):
    names, not_yet = UNLISTED[module]
    port = importlib.import_module(_port(module))
    missing = sorted(n for n in names.split() if not hasattr(port, n))
    assert missing == sorted(not_yet.split())
