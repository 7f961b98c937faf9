"""The port's sharding rules and planner against JAX's (no devices, no
subprocess): ``param_specs``, ``opt_specs`` (ZeRO-1's ``zero1_spec``),
``batch_specs`` and ``guard`` of ``core/sharding.py``, and ``auto_plan``'s
``dp_heavy``, ``seq_shard``, ``grad_sync`` and notes, compared as tuples
at full width for olmo-1b, recllm-base, deepseek-7b, internlm2-20b,
qwen3-moe-30b-a3b and rwkv6-1.6b on ``(data, model)`` meshes (1, 1),
(2, 2), (4, 2), (1, 4) and the ``(pod, data, model)`` mesh (2, 2, 2); and
the stage bounds and notes ``auto_plan`` gives a ``(data, model, stage)``
mesh under both pipeline schedules.

JAX gets a stand-in mesh (``shape``, ``axis_names``, ``size``): its rules
read nothing else.  The port gets a ``DPMesh`` with no process groups.
Parameter shapes come from JAX's ``eval_shape`` of each init (no
arrays).  Remat is held to the port's own rule, which weighs one H100's
memory where JAX weighs a TPU chip's.
"""
import dataclasses
import functools
import math

import pytest

ARCHS = ("olmo-1b", "recllm-base", "deepseek-7b", "internlm2-20b",
         "qwen3-moe-30b-a3b", "rwkv6-1.6b")
MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 2},
          {"data": 4, "model": 2}, {"data": 1, "model": 4},
          {"pod": 2, "data": 2, "model": 2})
N_USERS = 1001          # RecLLM's CF user rows: odd, so guard falls back


@dataclasses.dataclass(frozen=True)
class _JaxMesh:
    """What ``repro.core.sharding``/``hybrid`` read of a mesh."""
    shape: dict
    axis_names: tuple
    size: int


def _meshes(shape):
    from repro_torch.core.hierarchical import DPMesh
    jm = _JaxMesh(dict(shape), tuple(shape), math.prod(shape.values()))
    tm = DPMesh(shape=dict(shape), coords={a: 0 for a in shape}, groups={})
    return jm, tm


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """JAX's eval_shape of the arch's init: the tree both sides read."""
    import jax
    from repro.config import get_arch
    from repro.models import transformer as tf
    from repro.recsys import model as jrec
    cfg, key = get_arch(arch), jax.random.PRNGKey(0)
    if arch == "recllm-base":
        return jax.eval_shape(lambda: jrec.init_recllm(key, cfg, N_USERS))
    return jax.eval_shape(lambda: tf.init_params(key, cfg))


def _norm(spec):
    """A spec as a tuple, one-name tuples read as the name."""
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d
                 for d in spec)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def _plans(shape, **kw):
    from repro import config as jconfig
    from repro.core import sharding as jsh
    from repro_torch import config as tconfig
    from repro_torch.core import sharding as tsh
    jm, tm = _meshes(shape)
    return (jsh.make_plan(jm, jconfig.ParallelConfig(), **kw),
            tsh.make_plan(tm, tconfig.ParallelConfig(), **kw))


def _tuples(specs):
    """A JAX tree of PartitionSpecs as a tree of tuples."""
    import jax
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _same(jtree, ttree):
    jf = _flat(jtree)
    tf = _flat(ttree)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert _norm(jf[k]) == tf[k], (k, jf[k], tf[k])


def _mesh_id(shape):
    return "x".join(f"{a}{n}" for a, n in shape.items())


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_jax(arch, shape):
    from repro.config import get_arch as jarch
    from repro_torch.config import get_arch as tarch
    jplan, tplan = _plans(shape)
    params = _shapes(arch)
    _same(_tuples(jplan.param_specs(jarch(arch), params)),
          tplan.param_specs(tarch(arch), params))
    _same(_tuples(jplan.opt_specs(jarch(arch), params)),
          tplan.opt_specs(tarch(arch), params))


@pytest.mark.parametrize("dp_heavy", [False, True])
@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
def test_batch_specs_match_jax(shape, dp_heavy):
    import jax
    jplan, tplan = _plans(shape, dp_heavy=dp_heavy)
    for rows in (8, 2, 3):
        batch = {"tokens": jax.ShapeDtypeStruct((rows, 16), "int32"),
                 "mask": jax.ShapeDtypeStruct((rows, 16), "float32"),
                 "user": jax.ShapeDtypeStruct((rows,), "int32"),
                 "scalar": jax.ShapeDtypeStruct((), "float32")}
        _same(_tuples(jplan.batch_specs(batch)), tplan.batch_specs(batch))
    assert tplan.batch_axes == jplan.batch_axes


def test_guard_zero1_and_spec_has_axis_match_jax():
    from repro.core import sharding as jsh
    from repro_torch.core import sharding as tsh
    jplan, tplan = _plans({"pod": 2, "data": 2, "model": 2})
    cases = [((("pod", "data"), "model"), (8, 6)),
             ((("pod", "data"), "model"), (6, 6)),
             (("model", None, None), (3, 4, 4)),
             ((None, "data"), (5, 0))]
    for spec, shape in cases:
        assert _norm(jplan.guard(spec, shape)) == tplan.guard(spec, shape)
    for spec, shape in [((None, None), (12, 8)), (("model", None), (8, 12)),
                        ((), ()), ((None, "model"), (6, 4)),
                        ((None, None), (3, 5))]:
        want = _norm(jplan.zero1_spec(jsh.P(*spec), shape))
        assert tplan.zero1_spec(tsh.P(*spec), shape) == want, (spec, shape)
    for spec in [(None, "model"), (("pod", "data"), None), (None, None)]:
        for axis in ("model", "data", "pod"):
            assert tsh.spec_has_axis(tsh.P(*spec), axis) == \
                jsh.spec_has_axis(jsh.P(*spec), axis)


def _plan_fields(plan, drop_remat_note=True):
    notes = tuple(n for n in plan.notes
                  if not (drop_remat_note and n.startswith("remat on")))
    return (plan.sharding.dp_heavy, plan.sharding.seq_shard,
            plan.sharding.dp_axes, plan.sharding.tp_axis,
            plan.sharding.batch_axes, plan.grad_sync, notes)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_auto_plan_matches_jax(arch, shape):
    from repro import config as jconfig
    from repro.core import hybrid as jhy
    from repro_torch import config as tconfig
    from repro_torch.core import hybrid as thy
    jm, tm = _meshes(shape)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        jp = jhy.auto_plan(jconfig.get_arch(arch), jm, jconfig.SHAPES[name])
        tp = thy.auto_plan(tconfig.get_arch(arch), tm, tconfig.SHAPES[name])
        assert _plan_fields(tp) == _plan_fields(jp), (name, tp.notes)
        # remat: the port's rule, over one H100's memory
        s = tconfig.SHAPES[name]
        cfg = tconfig.get_arch(arch)
        act = (s.global_batch * s.seq_len * cfg.d_model * 2 * cfg.num_layers
               / math.prod(shape.values()))
        want = s.kind == "train" and 8 * act > 0.05 * tconfig.H100_HBM_BYTES
        assert tp.remat == want, (name, act)
        assert [n.startswith("remat on") for n in tp.notes].count(True) \
            == int(want)


def test_internlm2_train_4k_on_2x2_is_dp_heavy():
    """The case where JAX's planner picks the FSDP plan: the port too."""
    from repro_torch import config
    from repro_torch.core import hybrid
    _, tm = _meshes({"data": 2, "model": 2})
    plan = hybrid.auto_plan(config.get_arch("internlm2-20b"), tm,
                            config.SHAPES["train_4k"])
    assert plan.sharding.dp_heavy and plan.remat
    assert plan.sharding.batch_axes == ("data", "model")
    assert any(n.startswith("dp_heavy plan") for n in plan.notes)


@pytest.mark.parametrize("stages", [1, 2, 4])
@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-7b", "internlm2-20b"])
def test_auto_plan_stage_bounds_match_jax(arch, stages):
    """A ``stage`` axis: ``balance_stages`` over the layers' FLOPs gives
    JAX's bounds, and the notes (bounds, the schedule's bubble) are
    JAX's, under both schedules."""
    from repro import config as jconfig
    from repro.core import hybrid as jhy
    from repro_torch import config as tconfig
    from repro_torch.core import hybrid as thy
    jm, tm = _meshes({"data": 2, "model": 1, "stage": stages})
    for sched in ("1f1b", "gpipe"):
        jp = jhy.auto_plan(jconfig.get_arch(arch), jm,
                           jconfig.SHAPES["train_4k"],
                           jconfig.ParallelConfig(microbatches=4,
                                                  pp_schedule=sched))
        tp = thy.auto_plan(tconfig.get_arch(arch), tm,
                           tconfig.SHAPES["train_4k"],
                           tconfig.ParallelConfig(microbatches=4,
                                                  pp_schedule=sched))
        assert tp.stage_bounds == jp.stage_bounds
        assert len(tp.stage_bounds) == stages + 1
        assert _plan_fields(tp, drop_remat_note=True) == _plan_fields(
            jp, drop_remat_note=True), tp.notes
