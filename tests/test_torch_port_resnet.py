"""PyTorch port, ``models/resnet.py`` (the image CNN encoder's backbone)
against the JAX package's flax ResNet on the CPU, where cuDNN's place is
taken by torch's CPU convolutions:

* resnet18 / 34 / 50 forward: eval mode (running statistics) on
  (2, 32, 32, 3) in float32, to 1e-5 of the largest feature; training
  mode (batch statistics) and the running statistics it leaves on
  (2, 64, 64, 3) in float64 on both sides, to 1e-5 of the largest.
  Float64 because flax's BatchNorm forms its variance as
  E[x^2] - E[x]^2, which cancels away float32 digits where a channel's
  spread is small against its mean (float32 flax is 1e-5 .. 6e-4 of the
  largest feature from float64 flax at 64x64, the port's two-pass
  variance 1e-12 from it in float64).  64x64 because at 32x32 the last
  stage is 1x1 and each channel's statistics come from 2 values: each of
  resnet50's last three blocks then multiplies round-off by ~300, and
  float64 flax and the port part by 2e-5 of the largest feature there;
* the gradients of a loss through the training forward, parameters and
  input, against ``jax.grad`` on (2, 64, 64, 3) in float64 on both
  sides: ReLU after every BatchNorm makes a float32 gradient jump at
  round-off scale;
* bf16 (flax's ``dtype=bfloat16``): eval within 4 bf16 ulps of the
  largest feature of JAX's jitted forward; training mode within max(4
  ulps, 2 x the gap between JAX's jitted and op-by-op forwards) at
  (4, 64, 64, 3) (at 32x32 the 2-value statistics leave no digit in either
  JAX route); the parameters' gradients of a bf16 forward, eval and
  training mode, against JAX's bf16 gradients leaf by leaf, within 2x the
  gap between JAX's jitted and op-by-op routes (distance, and scale along
  the float32 gradient); bf16 gradients the same on every call where a
  stage is 1x1;
* the 4-D kernel mapping both ways (``utils/weights.py``), and
  ``load_torch_resnet_weights`` against JAX's on a torchvision-layout
  mapping built here (no torchvision in this image) and from a file;
* the int8 weight-only quantizer on the CNN's conv kernels, codes and
  scales bit for bit JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu.models.resnet import ResNet as JaxResNet
from multimodal_emotion_detection_tpu.models.resnet import (
    load_torch_resnet_weights as jax_load_torch_resnet_weights,
)
from multimodal_emotion_detection_tpu.utils.quantize import (
    quantize_tree as jax_quantize_tree,
)
from multimodal_emotion_detection_tpu_torch.models.resnet import (
    _VARIANTS,
    Bottleneck,
    ResNet,
    feature_dim,
    load_torch_resnet_weights,
)
from multimodal_emotion_detection_tpu_torch.utils.quantize import quantize_tree
from multimodal_emotion_detection_tpu_torch.utils.weights import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)

VARIANTS = ("resnet18", "resnet34", "resnet50")
ULP = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these small
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).astype(dtype), tree)


def _stats_like(stats, rng):
    """Running statistics away from init (mean 0, var 1), so eval mode
    reads them."""
    return {k: _stats_like(v, rng) if isinstance(v, dict) else
            (rng.randn(*v.shape) * 0.1 if k == "mean" else rng.rand(*v.shape) + 0.5)
            .astype(np.float32) for k, v in sorted(stats.items())}


def _jax_resnet(variant, shape, seed=0, dtype=jnp.float32):
    """A flax ResNet's float32 parameters and randomised statistics."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    net = JaxResNet(variant=variant, dtype=dtype)
    variables = jax.jit(lambda k: net.init(k, jnp.asarray(x)))(jax.random.PRNGKey(seed))
    stats = _stats_like(_np(variables["batch_stats"]), np.random.RandomState(seed + 1))
    return net, x, _np(variables["params"]), stats


def _port(variant, params, stats, dtype=torch.float32):
    model = ResNet(variant)
    model.load_state_dict(state_dict_from_jax_params(params, stats))  # strict
    return model.to(dtype)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("variant", VARIANTS)
def test_eval_forward_matches_flax(variant):
    net, x, params, stats = _jax_resnet(variant, (2, 32, 32, 3))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(net.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(x), deterministic=True))
    model = _port(variant, params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, feature_dim(variant)) == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("variant", VARIANTS)
def test_training_forward_and_running_statistics_match_flax(variant):
    net, x, params, stats = _jax_resnet(variant, (2, 64, 64, 3))
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        net64 = JaxResNet(variant=variant, dtype=jnp.float64)
        want, moved = net64.apply(
            {"params": _np(params, np.float64), "batch_stats": _np(stats, np.float64)},
            jnp.asarray(x, jnp.float64), deterministic=False, mutable=["batch_stats"])
        want, moved = np.asarray(want), _np(moved["batch_stats"], np.float64)
    model = _port(variant, params, stats, torch.float64).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).double()).numpy()
    assert _rel(got, want) <= 1e-5
    after = model.state_dict()
    for name, ref in state_dict_from_jax_params({}, moved).items():
        assert _rel(after[name].numpy(), ref.double().numpy()) <= 1e-5, name
    # bn_eval=True: the running statistics in a training-mode forward
    with torch.no_grad():
        held = model(torch.from_numpy(x).double(), bn_eval=True)
    assert all(torch.equal(after[k], v) for k, v in model.state_dict().items())
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(held, model(torch.from_numpy(x).double()),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_gradients_match_jax_grad_in_float64(variant):
    net, x, params, stats = _jax_resnet(variant, (2, 64, 64, 3))
    w = np.random.RandomState(7).randn(feature_dim(variant))
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        net64 = JaxResNet(variant=variant, dtype=jnp.float64)
        stats64 = _np(stats, np.float64)

        def loss(p, xx):
            feats, _ = net64.apply({"params": p, "batch_stats": stats64}, xx,
                                   deterministic=False, mutable=["batch_stats"])
            return jnp.sum(feats * w) + 0.1 * jnp.sum(feats ** 2)

        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            _np(params, np.float64), jnp.asarray(x, jnp.float64))
        gp, gx = _np(gp, np.float64), np.asarray(gx)
    model = _port(variant, params, stats, torch.float64).train()
    xt = torch.from_numpy(x).double().requires_grad_(True)
    feats = model(xt)
    wt = torch.from_numpy(w)
    (torch.sum(feats * wt) + 0.1 * torch.sum(feats ** 2)).backward()
    want = {}  # the JAX gradients under the port's names, kept in float64
    for path, leaf in jax.tree_util.tree_leaves_with_path(gp):
        *mods, key = [k.key for k in path]
        if key == "kernel":
            leaf = leaf.transpose(3, 2, 0, 1)
        want[".".join(mods + ["bias" if key == "bias" else "weight"])] = torch.from_numpy(leaf)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    g_max = max(float(g.abs().max()) for g in want.values())
    worst = max(float((got[k] - g).abs().max()) for k, g in want.items()) / g_max
    assert worst <= 1e-8
    assert _rel(xt.grad.numpy(), gx) <= 1e-8


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_bf16_forward_within_the_bf16_rule(variant, mode):
    shape = (2, 32, 32, 3) if mode == "eval" else (4, 64, 64, 3)
    net, x, params, stats = _jax_resnet(variant, shape, dtype=jnp.bfloat16)
    variables = {"params": params, "batch_stats": stats}

    def fwd(v, xx):
        return net.apply(v, xx, deterministic=mode == "eval",
                         mutable=["batch_stats"])[0].astype(jnp.float32)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(fwd)(variables, jnp.asarray(x)))
        with jax.disable_jit():
            eager = np.asarray(fwd(variables, jnp.asarray(x)))
    model = _port(variant, params, stats).train(mode == "train")
    with torch.no_grad():
        out = model(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    ulps = _rel(out.float().numpy(), want) / ULP
    jax_routes = _rel(eager, want) / ULP
    bound = 4.0 if mode == "eval" else max(4.0, 2 * jax_routes)
    print(f"{variant} {mode}: port {ulps:.2f} bf16 ulps from JAX's jitted forward, "
          f"JAX's op-by-op forward {jax_routes:.2f} (bound {bound:.2f})")
    assert ulps <= bound
    # the running statistics stay float32
    assert all(b.dtype == torch.float32 for b in model.buffers())


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_bf16_gradients_match_jax_leaf_by_leaf(mode):
    """The float32 parameters' gradients of a bf16 resnet18 forward (eval:
    running statistics; train: batch statistics) against JAX's jitted
    bf16 gradients on the same inputs, leaf by leaf, each bound set by the
    gap between JAX's own two routes (jitted and op-by-op):

    * the leaf's L2 distance from JAX's jitted gradient within 2x that of
      JAX's op-by-op gradient (readings: the port's at most 1.24x in eval
      and 1.13x in training, median 1.04x / 0.96x; the routes' own gap a
      median 0.08 / 0.36 of the leaf's norm: in training bf16 rounding
      through 17 BatchNorm backwards swamps much of every leaf);
    * the leaf's scale along JAX's float32 gradient f, <g, f> / <jit, f>,
      within 2x the largest |scale - 1| of JAX's op-by-op gradient over
      the leaves (readings: the port's at most 0.038 / 0.113, JAX's
      0.062 / 0.083).  Rounding noise leaves the scale near 1 where it
      swamps the distance; a gradient wrong by a factor moves it.

    A halved port gradient fails both rules on every leaf in eval and the
    scale rule on every leaf in training.  The loss weights differ per
    clip: a weight shared by the batch is what BatchNorm's backward
    subtracts, and its rounding would swamp the rest."""
    _, x, params, stats = _jax_resnet("resnet18", (4, 64, 64, 3))
    w = np.random.RandomState(7).randn(4, 512).astype(np.float32)

    def jax_grads(dtype, jit=True):
        net = JaxResNet(variant="resnet18", dtype=dtype)

        def loss(p):
            feats, _ = net.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                 deterministic=mode == "eval", mutable=["batch_stats"])
            return jnp.sum(feats.astype(jnp.float32) * w)

        with jax.default_matmul_precision("highest"):
            if jit:
                grads = jax.jit(jax.grad(loss))(params)
            else:
                with jax.disable_jit():
                    grads = jax.grad(loss)(params)
        return state_dict_from_jax_params(_np(grads))

    model = _port("resnet18", params, stats).train(mode == "train")
    feats = model(torch.from_numpy(x).bfloat16())
    (feats.float() * torch.from_numpy(w)).sum().backward()
    port = {k: p.grad for k, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in port.values())
    jit, eager, full = jax_grads(jnp.bfloat16), jax_grads(jnp.bfloat16, False), jax_grads(jnp.float32)
    assert set(port) == set(jit)

    def dist(got, k):
        return float((got[k] - jit[k]).norm() / jit[k].norm())

    def scale(got, k):
        return float((got[k] * full[k]).sum() / (jit[k] * full[k]).sum())

    scale_bound = 2 * max(abs(scale(eager, k) - 1) for k in jit)

    def failing(got):
        far = {k for k in jit if dist(got, k) > 2 * dist(eager, k)}
        off = {k for k in jit if abs(scale(got, k) - 1) > scale_bound}
        return far, off

    ratios = [dist(port, k) / dist(eager, k) for k in jit]
    gap = float(np.median([dist(eager, k) for k in jit]))
    print(f"{mode}: port / JAX op-by-op distance from JAX jitted, leaf by leaf: max "
          f"{max(ratios):.3f}, median {float(np.median(ratios)):.3f} (JAX's median "
          f"{gap:.3f} of the leaf's norm); |scale - 1| max "
          f"{max(abs(scale(port, k) - 1) for k in jit):.3f} (bound {scale_bound:.3f})")
    assert failing(port) == (set(), set())
    far, off = failing({k: g * 0.5 for k, g in port.items()})
    assert off == set(jit)
    if mode == "eval":
        assert far == set(jit)


def test_bf16_gradients_repeat_bit_for_bit_where_a_stage_is_1x1():
    """At 16x16 stage 2 ends 1x1 and stage 3 opens with a strided 3x3
    convolution of a 1x1 input, whose backward in torch's CPU bf16 kernel
    reads uninitialised memory (1e23 or NaN gradients, a new value each
    call).  There the port's CPU bf16 convolution sums in float32: the
    gradients are finite and the same on every call, with freed NaN
    buffers lying about."""
    _, x, params, stats = _jax_resnet("resnet18", (16, 16, 16, 3))
    model = _port("resnet18", params, stats).train()
    grads = []
    for _ in range(5):
        junk = [torch.full((n,), float("nan")) for n in (1 << 12, 1 << 14, 1 << 16, 1 << 18)
                for _ in range(64)]
        del junk
        model.zero_grad()
        feats = model(torch.from_numpy(x).bfloat16())
        (feats.float() * torch.linspace(-1, 1, feats.numel()).reshape(feats.shape)).sum().backward()
        grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(torch.equal(g, grads[0]) for g in grads[1:])


@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_4d_kernels_map_both_ways(variant):
    _, _, params, stats = _jax_resnet(variant, (1, 32, 32, 3))
    sd = state_dict_from_jax_params(params, stats)
    stem = params["stem_conv"]["kernel"]
    assert stem.shape == (7, 7, 3, 64)
    np.testing.assert_array_equal(sd["stem_conv.weight"].numpy(),
                                  stem.transpose(3, 2, 0, 1))
    down = params["stage1_block0"]["downsample_conv"]["kernel"]
    np.testing.assert_array_equal(sd["stage1_block0.downsample_conv.weight"].numpy(),
                                  down.transpose(3, 2, 0, 1))
    back = jax_params_from_state_dict(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    # a 4-D kernel of a module named otherwise raises, as a 3-D one does
    with pytest.raises(ValueError, match="4-D Conv"):
        state_dict_from_jax_params({"proj": {"kernel": stem}})


def _torchvision_mapping(variant, seed):
    """A torchvision-layout resnet ``state_dict`` of random tensors: the
    names and shapes of ``torchvision.models.<variant>()`` without ``fc``,
    ``num_batches_tracked`` included."""
    gen = torch.Generator().manual_seed(seed)
    block_cls, stage_sizes = _VARIANTS[variant]
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k, generator=gen) * 0.1

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=gen) + 0.5
        sd[f"{name}.bias"] = torch.randn(c, generator=gen) * 0.1
        sd[f"{name}.running_mean"] = torch.randn(c, generator=gen) * 0.1
        sd[f"{name}.running_var"] = torch.rand(c, generator=gen) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    width = 64
    for stage, blocks in enumerate(stage_sizes):
        feat = 64 * 2 ** stage
        for b in range(blocks):
            p = f"layer{stage + 1}.{b}"
            if block_cls is Bottleneck:
                shapes = [(feat, width, 1), (feat, feat, 3), (4 * feat, feat, 1)]
            else:
                shapes = [(feat, width, 3), (feat, feat, 3)]
            for i, (cout, cin, k) in enumerate(shapes, 1):
                conv(f"{p}.conv{i}", cout, cin, k)
                bn(f"{p}.bn{i}", cout)
            out = feat * block_cls.expansion
            if width != out:
                conv(f"{p}.downsample.0", out, width, 1)
                bn(f"{p}.downsample.1", out)
            width = out
    sd["fc.weight"] = torch.zeros(1000, width)
    return sd


@pytest.mark.parametrize("source", ["mapping", "file"])
@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_load_torch_resnet_weights_matches_jax(variant, source, tmp_path):
    mapping = _torchvision_mapping(variant, 3)
    arg = mapping
    if source == "file":
        arg = tmp_path / f"{variant}.pth"
        torch.save(mapping, arg)
    got = load_torch_resnet_weights(arg, variant=variant)
    _, _, params, stats = _jax_resnet(variant, (1, 32, 32, 3))
    loaded = jax_load_torch_resnet_weights({"params": params, "batch_stats": stats},
                                           mapping, variant=variant)
    want = state_dict_from_jax_params(_np(loaded["params"]), _np(loaded["batch_stats"]))
    assert set(got) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
    # the entries load into the port's backbone, every key of it
    ResNet(variant).load_state_dict(got)


def test_quantizer_takes_the_cnn_kernels_per_output_channel():
    _, _, params, _ = _jax_resnet("resnet18", (1, 32, 32, 3))
    back = jax_params_from_state_dict(state_dict_from_jax_params(params))
    got, got_stats = quantize_tree(back, min_size=1024)
    want, want_stats = jax_quantize_tree(params, min_size=1024)
    assert got_stats == want_stats
    stem, ref = got["stem_conv"]["kernel"], want["stem_conv"]["kernel"]["::int8::"]
    assert stem["scale"].shape == (1, 1, 1, 64)  # one scale per output channel
    np.testing.assert_array_equal(stem["q"], np.asarray(ref["q"]))
    np.testing.assert_array_equal(stem["scale"], np.asarray(ref["scale"]))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
