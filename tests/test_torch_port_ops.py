"""PyTorch port, the serving kernels as ``torch.library`` custom ops
(``med_torch::logmel``, ``lstm2_infer``, ``gru2_infer``, ``lstm1_infer``,
``gru1_infer``, ``flash_fwd``) on the CPU: each passes
``torch.library.opcheck`` (schema, fake kernel, AOT dispatch), its CPU
kernel is its plain version bit for bit, a trace of it is one graph node,
and a CPU call launches nothing.  No JAX: the plain versions are held
against the JAX kernels in the files of their modules.  The card's side
is ``tests/test_torch_port_gpu.py -k op``."""

import numpy as np
import pytest
import torch

from multimodal_emotion_detection_tpu_torch.ops import flash_attention as fa
from multimodal_emotion_detection_tpu_torch.ops import logmel
from multimodal_emotion_detection_tpu_torch.ops import lstm_kernel as lk
from multimodal_emotion_detection_tpu_torch.ops._build import OPS_NAMESPACE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test workers on the same cores; at these tiny
    # shapes a multi-threaded torch only spins idle threads that slow them all
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _lstm_layers(rng, d, h):
    return [{"w_ih": _rand(rng, din, 4 * h) * 0.3, "w_hh": _rand(rng, h, 4 * h) * 0.3,
             "b": _rand(rng, 4 * h) * 0.1} for din in (d, h)]


def _gru_layers(rng, d, h):
    return [{"w_ih": _rand(rng, din, 3 * h) * 0.3, "w_hh": _rand(rng, h, 3 * h) * 0.3,
             "b_ih": _rand(rng, 3 * h) * 0.1, "b_hh": _rand(rng, 3 * h) * 0.1}
            for din in (d, h)]


def _flash_inputs(rng, b, h, tq, tk, d, dtype=torch.float32, bias=False, rate=0.0):
    q, k, v = (_rand(rng, b, h, t, d).to(dtype) for t in (tq, tk, tk))
    key_bias = None
    if bias:
        key_bias = torch.zeros(b, tk)
        key_bias[0, tk // 2:] = fa.MASKED
    seed = torch.tensor([20240917], dtype=torch.int64) if rate > 0.0 else None
    return q, k, v, key_bias, seed, rate


def _cases():
    """(id, op, its arguments, the wrapper's output, the plain version's)."""
    rng = np.random.RandomState(0)
    cases = []
    for name, wave, params in (
            ("logmel", _rand(rng, 2, 2048), logmel.LogMelParams()),
            ("logmel_3d_hop160", _rand(rng, 3, 3000, 1), logmel.LogMelParams(hop_length=160)),
            ("logmel_fmax", _rand(rng, 1, 1000),
             logmel.LogMelParams(n_fft=256, win_length=200, hop_length=80, n_mels=40,
                                 fmin=50.0, fmax=6000.0))):
        args = (wave, params.sample_rate, params.n_fft, params.hop_length,
                params.win_length, params.n_mels, params.fmin, params.fmax,
                params.log_epsilon)
        cases.append((name, logmel.LOGMEL_OP, args, lambda w=wave, p=params: (
            logmel.logmel_cuda(w, p), logmel.logmel_frames(w, p))))
    x = _rand(rng, 3, 7, 5)
    l0, l1 = _lstm_layers(rng, 5, 8)
    cases.append(("lstm2_infer", lk.LSTM2_INFER_OP,
                  (x, l0["w_ih"], l0["w_hh"], l0["b"], l1["w_ih"], l1["w_hh"], l1["b"]),
                  lambda: (lk.lstm2_infer(x, l0, l1), lk.lstm2_infer_reference(x, l0, l1))))
    x16 = x.to(torch.bfloat16)
    cases.append(("lstm2_infer_bf16_x", lk.LSTM2_INFER_OP,
                  (x16, l0["w_ih"], l0["w_hh"], l0["b"], l1["w_ih"], l1["w_hh"], l1["b"]),
                  lambda: (lk.lstm2_infer(x16, l0, l1), lk.lstm2_infer_reference(x16, l0, l1))))
    g0, g1 = _gru_layers(rng, 5, 8)
    keys = ("w_ih", "w_hh", "b_ih", "b_hh")
    cases.append(("gru2_infer", lk.GRU2_INFER_OP,
                  (x, *(g0[k] for k in keys), *(g1[k] for k in keys)),
                  lambda: (lk.gru2_infer(x, g0, g1), lk.gru2_infer_reference(x, g0, g1))))
    ih4, ih3 = _rand(rng, 6, 3, 32), _rand(rng, 6, 3, 24)
    for series in (True, False):
        tag = "series" if series else "final"
        cases.append((f"lstm1_infer_{tag}", lk.LSTM1_INFER_OP, (ih4, l1["w_hh"], series),
                      lambda s=series: (lk.lstm1_infer(ih4, l1["w_hh"], s),
                                        lk.lstm1_infer_reference(ih4, l1["w_hh"], s))))
        cases.append((f"gru1_infer_{tag}", lk.GRU1_INFER_OP,
                      (ih3, g1["w_hh"], g1["b_hh"], series),
                      lambda s=series: (lk.gru1_infer(ih3, g1["w_hh"], g1["b_hh"], s),
                                        lk.gru1_infer_reference(ih3, g1["w_hh"],
                                                                g1["b_hh"], s))))
    for name, kw in (("flash_fwd", {}), ("flash_fwd_bias_dropout", dict(bias=True, rate=0.1)),
                     ("flash_fwd_bf16", dict(dtype=torch.bfloat16, bias=True)),
                     ("flash_fwd_bf16_dropout", dict(dtype=torch.bfloat16, rate=0.1))):
        args = _flash_inputs(rng, 2, 2, 9, 11, 8, **kw)
        cases.append((name, fa.FLASH_FWD_OP, args, lambda a=args: (
            fa.flash_fwd(*a), fa.flash_fwd_reference(*a))))
    return cases


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_passes_opcheck(case):
    _, op, args, _ = case
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wrapper_is_the_plain_version_bit_for_bit_on_the_cpu(case):
    counters = (logmel.LOGMEL, lk.LSTM2_INFER, lk.GRU2_INFER, lk.LSTM1_INFER,
                lk.GRU1_INFER, fa.FLASH_FWD, fa.FLASH_FWD_BF16)
    before = [c.launches for c in counters]
    got, ref = case[3]()
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape and g.is_contiguous()
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_traced_op_is_one_graph_node(case):
    _, op, args, _ = case

    class Call(torch.nn.Module):
        def forward(self, *tensors):
            it = iter(tensors)
            return op(*(next(it) if isinstance(a, torch.Tensor) else a for a in args))

    tensors = tuple(a for a in args if isinstance(a, torch.Tensor))
    program = torch.export.export(Call(), tensors)
    calls = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    target = f"{op._namespace}.{op._name}.default"
    assert calls.count(target) == 1
    assert all(c in (target, "<built-in function getitem>") for c in calls), calls
    torch.testing.assert_close(program.module()(*tensors), op(*args), rtol=0, atol=0)


def test_every_serving_wrapper_has_an_op():
    names = ("logmel", "lstm2_infer", "gru2_infer", "lstm1_infer", "gru1_infer",
             "flash_fwd")
    assert {(op._namespace, op._name) for _, op, _, _ in CASES} == {
        (OPS_NAMESPACE, n) for n in names}
    for name in names:
        assert hasattr(getattr(torch.ops, OPS_NAMESPACE), name)


def test_ops_have_no_gradient_the_training_routes_keep_theirs():
    # the ops serve: differentiating through one raises, so an eval-mode
    # recurrence or the log-mel cannot silently join a training graph;
    # attention keeps its gradient through FlashAttention (the op inside
    # its forward)
    rng = np.random.RandomState(3)
    wave = _rand(rng, 1, 1024).requires_grad_()
    with pytest.raises(RuntimeError, match="no autograd formula"):
        logmel.logmel_cuda(wave, logmel.LogMelParams()).sum().backward()
    q, k, v, bias, _, _ = _flash_inputs(rng, 1, 2, 5, 6, 4, bias=True)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fa.flash_attention(q, k, v, bias).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_wrappers_refuse_what_they_refused():
    rng = np.random.RandomState(4)
    q, k, v, _, _, _ = _flash_inputs(rng, 1, 1, 3, 3, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), k.half(), v.half(), None, None, 0.0)
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_fwd(q, k.to(torch.bfloat16), v, None, None, 0.0)
    with pytest.raises(ValueError, match="shorter than one STFT window"):
        logmel.logmel_cuda(torch.zeros(1, 100), logmel.LogMelParams())
