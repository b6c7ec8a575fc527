"""The one binding of the hand-written kernels (``kernels/_build.py``): every
kernel module's ``soccdpt::`` op with its CPU and fake implementations,
``torch.library.opcheck`` of the ops that K2, K3-K5 and K7 became, and
the counts ``kernels.ops.launches()`` and ``fallbacks()``.

The card's side (each op's CUDA implementation under ``opcheck``) is in
``tests/test_torch_kernels_gpu.py``; the C calls each launcher makes, through
fake libraries, in ``tests/test_torch_{attention,window,conv}_plan.py``.
"""
import pytest
import torch
from torch.library import opcheck

from soccdpt_torch.kernels import _build, ops
from soccdpt_torch.kernels.fused_fusion import fused_rcu_tail_plain
from soccdpt_torch.kernels.fused_head import fused_head_tail_plain
from soccdpt_torch.kernels.fused_rcu import fused_rcu_plain
from soccdpt_torch.kernels.global_attention import global_attention_backward_plain
from soccdpt_torch.kernels.segment_sum import segment_sum_backward_plain, segment_sum_plain

OPS = ("fused_head_tail", "fused_rcu", "fused_rcu_tail", "global_attention",
       "global_attention_backward", "global_attention_with_lse", "segment_sum",
       "segment_sum_backward", "unproject_slots", "upsample2x", "window_attention")


@pytest.mark.parametrize("name", OPS)
def test_every_kernel_is_an_op_with_cuda_cpu_and_fake_implementations(name):
    qualified = f"soccdpt::{name}"
    for key in ("CUDA", "CPU", "Meta"):  # the fake implementation serves Meta
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), key
    assert hasattr(torch.ops.soccdpt, name)


def test_launches_names_every_op_and_fallbacks_the_two_with_a_plain_path():
    assert tuple(ops.launches()) == OPS
    assert tuple(ops.fallbacks()) == ("upsample2x", "unproject_slots")
    assert ops.launches is _build.launches and ops.fallbacks is _build.fallbacks


def _randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _keys(n, slots):
    """int32 keys, some below 0 and some past the last slot (dropped)."""
    return torch.randint(-3, slots + 4, (n,), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)


def _decoder(C=8, Cm=4):
    """x, w1, b1, w2, b2 of an RCU at C channels, and a head's 3x3 weight to Cm."""
    return (_randn(1, 5, 6, C), _randn(3, 3, C, C, seed=1) * 0.1, _randn(C, seed=2),
            _randn(3, 3, C, C, seed=3) * 0.1, _randn(C, seed=4),
            _randn(3, 3, C, Cm, seed=5) * 0.1, Cm)


def _case(name):
    """(op name, its arguments, the plain version's output) at a small shape."""
    if name.startswith("segment_sum"):
        lin, vals = _keys(30, 16), _randn(2, 15, 3)
        if name == "segment_sum":
            return (lin, vals, 16), segment_sum_plain(lin, vals, 16)
        cot = _randn(16, 3)
        return (lin, cot), segment_sum_backward_plain(lin, cot)
    if name.startswith("global_attention_backward"):
        q, k, v, g = (_randn(2, 2, 9, 16, seed=i) for i in range(4))
        bias = None if name.endswith("nobias") else _randn(2, 9, 9, seed=4)
        dq, dk, dv, dbias = global_attention_backward_plain(q, k, v, bias, 0.25, g)
        want = (dq, dk, dv, torch.empty(0) if bias is None else dbias)
        return (q, k, v, bias, None, None, g, 0.25, bias is not None), want
    x, w1, b1, w2, b2, wh, Cm = _decoder()
    if name == "fused_rcu":
        return (x, w1, b1, w2, b2, None), fused_rcu_plain(x, w1, b1, w2, b2)
    if name == "fused_rcu_tail":
        wo, bo = _randn(8, 8, seed=6), _randn(8, seed=7)
        return (x, w1, b1, w2, b2, wo, bo, None), fused_rcu_tail_plain(x, w1, b1, w2, b2, wo, bo)
    args = (x, wh, _randn(Cm, seed=8), _randn(Cm, seed=9), _randn(1, seed=10))
    return args, fused_head_tail_plain(*args)


NEW_OPS = ["segment_sum", "segment_sum_backward", "global_attention_backward",
           "global_attention_backward_nobias", "fused_rcu", "fused_rcu_tail", "fused_head_tail"]


@pytest.mark.parametrize("case", NEW_OPS)
def test_the_new_ops_pass_opcheck_and_are_the_plain_versions_on_the_cpu(case):
    """K2, K7 (with a bias and without) and K3-K5 as ops on CPU tensors:
    ``opcheck`` (schema, fake implementation, a traced call) passes, the op
    gives the plain version bit for bit, and no launch is counted."""
    op = getattr(torch.ops.soccdpt, case.removesuffix("_nobias")).default
    args, want = _case(case)
    opcheck(op, args)
    before = ops.launches()
    got = op(*args)
    assert ops.launches() == before  # the CPU runs the plain version
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("name", ["upsample2x", "unproject_slots"])
def test_a_fallback_counts_under_its_kernel_alone(name):
    before = ops.fallbacks()
    ops.count_fallback(name)
    after = ops.fallbacks()
    assert {k: after[k] - before[k] for k in after} == {k: int(k == name) for k in after}
    with pytest.raises(KeyError):
        ops.count_fallback("window_attention")  # only a kernel with a plain path falls back
