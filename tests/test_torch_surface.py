"""The port's surface held to ``tools/api_spec.json``.

For every ``paddle_tpu.*`` module of the spec that has a counterpart in
``paddle_tpu_torch`` (the same dotted path), the spec's module-level
names the port does not expose must equal the not-yet-ported list kept
here, one case a module.  A name that gets ported is taken off its list
in the same change, and a module that gets ported is added with its
list, so the lists shrink as the port grows.  The test reads the JSON
file and imports only ``paddle_tpu_torch``.  Members of classes (the
spec's dotted names) are not held here."""
import importlib
import json
import os

import pytest

SPEC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "api_spec.json")

# module -> the spec's module-level names the port lacks
NOT_YET_PORTED = {
    "paddle_tpu": """
        CPUPlace CUDAPinnedPlace CUDAPlace DataParallel Model
        Parameter TPUPlace Tensor XPUPlace abs acos acosh add add_n addmm all
        allclose amax amin angle annotations any apply argmax argmin argsort
        as_array as_strided asin asinh assign atan atan2 atanh bernoulli
        bfloat16 bitwise_and bitwise_not bitwise_or bitwise_xor bmm bool_
        broadcast_shape broadcast_tensors broadcast_to bucketize builtins_slice
        case cast ceil cholesky chunk clip clone complex complex128 complex64
        concat cond conj convert_dtype cos cosh count_nonzero create_parameter
        crop_tensor cross cummax cumprod cumsum deg2rad device_count diag
        diagflat diff digamma disable_dygraph dist divide dot einsum
        enable_dygraph enable_grad equal equal_all erf erfinv exp
        expand expand_as expm1 exponential_ eye flatten flip float16 float32
        float64 floor floor_divide floor_mod flops fmax fmin frac
        gather gather_nd get_cuda_rng_state get_cudnn_version get_default_dtype
        get_flags get_rng_state getitem grad greater_equal greater_than
        histogram hypot imag in1d in_dygraph_mode increment index_sample
        index_select inner int16 int32 int64 int8 inverse is_compiled_with_cuda
        is_compiled_with_tpu is_compiled_with_xpu is_empty is_grad_enabled
        is_tensor isclose isfinite isin isinf isnan kron kthvalue lerp
        less_equal less_than lgamma linspace load log log10 log1p log2 logaddexp
        logcumsumexp logical_and logical_not logical_or logical_xor logspace
        logsumexp masked_fill masked_select matmul max maximum mean median
        meshgrid min minimum mm mod mode monkey_patch_tensor moveaxis
        multinomial multiplex multiply mv nan_to_num nanmean nansum neg next_key
        no_grad nonzero norm normal normal_ not_equal numel one_hot
        outer pad paged_attention paged_attention_supported poisson
        pow prod put_along_axis rad2deg rand randint randint_like randn randperm
        rank real reciprocal register_paged_attention_kernel remainder
        repeat_interleave reshape reshape_ roll rot90 round rsqrt save scale
        scatter scatter_ scatter_nd scatter_nd_add searchsorted
        set_cuda_rng_state set_default_dtype set_flags set_printoptions
        set_rng_state setitem shape shard_index shuffle sigmoid sign sin sinh
        slice sort split sqrt square squeeze squeeze_ stack standard_normal
        stanh std strided_slice subtract sum summary swapaxes switch_case t
        take_along_axis tan tanh tanh_ tile to_tensor topk trace tril
        triu trunc uint8 unbind uniform uniform_ unique unsqueeze unsqueeze_
        unstack var where while_loop
    """,
    "paddle_tpu.amp": """
        Tensor
    """,
    "paddle_tpu.distributed": """
        AnomalyEscalation AnomalyPolicy Fleet ProcessSupervisor
        ServingSupervisor ShardedState ShardingPlan SpecLayout StepWatchdog
        SupervisorGaveUp SupervisorResult TrainingSupervisor all_gather_object
        early_init fleet gather_tree in_spmd match_partition_rules mesh_users
        named_sharding plan_for_params register_mesh_user release_mesh_user
        shard_tree spec_divisor specs_for_state split with_constraint
    """,
    "paddle_tpu.jit": """
        InputSpec LintDiagnostic StaticFunction TranslatedLayer bind
        buffer_arrays enable_to_static lint load not_to_static param_arrays
        param_list save to_static
    """,
    "paddle_tpu.nn": """
        AdaptiveAvgPool1D AdaptiveAvgPool2D AdaptiveAvgPool3D AdaptiveMaxPool1D
        AdaptiveMaxPool2D AdaptiveMaxPool3D AlphaDropout AvgPool1D AvgPool2D
        AvgPool3D BCELoss BCEWithLogitsLoss BatchNorm BatchNorm1D BatchNorm2D
        BatchNorm3D BeamSearchDecoder BiRNN Bilinear CELU CTCLoss
        ClipGradByGlobalNorm ClipGradByNorm ClipGradByValue Conv1D
        Conv1DTranspose Conv2D Conv2DTranspose Conv3D Conv3DTranspose
        CosineEmbeddingLoss CosineSimilarity CrossEntropyLoss Dropout2D
        Dropout3D ELU Flatten GELU GLU GRU GRUCell GroupNorm HSigmoidLoss
        Hardshrink Hardsigmoid Hardswish Hardtanh HingeEmbeddingLoss Identity
        InstanceNorm1D InstanceNorm2D InstanceNorm3D KLDivLoss L1Loss LSTM
        LSTMCell Layer LayerDict LeakyReLU LocalResponseNorm LogSigmoid
        LogSoftmax MSELoss MarginRankingLoss MaxPool1D MaxPool2D MaxPool3D
        Maxout Mish NLLLoss PReLU Pad1D Pad2D Pad3D PairwiseDistance
        ParameterList PixelShuffle RNN RNNCellBase ReLU ReLU6 SELU Sequential
        Sigmoid Silu SimpleRNN SimpleRNNCell SmoothL1Loss Softmax Softplus
        Softshrink Softsign SpectralNorm Swish SyncBatchNorm Tanh Tanhshrink
        ThresholdedReLU Transformer TransformerDecoder TransformerDecoderLayer
        Unfold Upsample UpsamplingBilinear2D UpsamplingNearest2D cell_step
        dynamic_decode gather_tree remove_weight_norm weight_norm
    """,
    "paddle_tpu.nn.functional": """
        Tensor adaptive_avg_pool1d adaptive_avg_pool2d adaptive_avg_pool3d
        adaptive_max_pool1d adaptive_max_pool2d adaptive_max_pool3d affine_grid
        alpha_dropout as_array avg_pool1d avg_pool2d avg_pool3d batch_norm
        bilinear binary_cross_entropy binary_cross_entropy_with_logits celu
        conv1d conv1d_transpose conv2d conv2d_transpose conv3d conv3d_transpose
        cosine_embedding_loss cosine_similarity ctc_loss diag_embed dice_loss
        dropout2d dropout3d elu elu_ gather_tree glu grid_sample group_norm
        gumbel_softmax hardshrink hardsigmoid hardswish hardtanh
        hinge_embedding_loss hsigmoid_loss instance_norm interpolate kl_div
        l1_loss label_smooth leaky_relu local_response_norm log_loss log_sigmoid
        log_softmax margin_ranking_loss max_pool1d max_pool2d max_pool3d maxout
        mish next_key nll_loss normalize np_asarray npair_loss one_hot pad
        pixel_shuffle prelu relu6 relu_ selu sequence_mask sigmoid
        sigmoid_focal_loss silu smooth_l1_loss softmax softmax_
        softmax_with_cross_entropy softplus softshrink softsign
        square_error_cost squeeze stable_draw swish tanh tanh_ tanhshrink
        temporal_shift thresholded_relu unfold unsqueeze upsample
    """,
    "paddle_tpu.optimizer": """
        Adadelta Adagrad Adamax ClipGradByNorm ClipGradByValue DecayedAdagrad
        Dpsgd ExponentialMovingAverage Ftrl L1Decay L2Decay Lamb LarsMomentum
        Lookahead LookaheadOptimizer ModelAverage Momentum ProximalAdagrad
        ProximalGD RMSProp SGD clip_grad_norm_
    """,
    "paddle_tpu.nn.initializer": """
        next_key
    """,
    "paddle_tpu.optimizer.lr": "",
    "paddle_tpu.serving": """
        ElasticityController InferenceEngine ModelEntry ModelRegistry
        QuotaExceeded ReplicaSet UnknownModel WeightWatcher publish_weights
    """,
    "paddle_tpu.static": """
        BuildStrategy CompiledProgram InputSpec load_inference_model
        save_inference_model
    """,
    "paddle_tpu.utils": """
        register_custom_op train_epoch_range
    """,
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


def test_every_ported_module_has_a_case():
    ported = sorted(m for m in _spec() if _has_counterpart(m))
    assert ported == sorted(NOT_YET_PORTED)
