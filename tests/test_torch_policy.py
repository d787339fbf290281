"""The port's sharding policy and sharding trees (``repro_torch.sharding
.policy``, ``repro_torch.launch.shardings``) against the JAX package's.

The JAX side builds its meshes as ``jax.sharding.AbstractMesh`` on the one
CPU device; the port's are ``DeviceMesh``es over a dry world (the
``"fake"`` backend) of as many ranks, which a fixture opens and always
destroys, so no process group leaks into the next test file a worker runs.
Specs are compared entry by entry (JAX writes a one-axis tuple as the
axis name). The port holds one tensor per layer where the JAX tree stacks
the layers, so a JAX spec of a stacked leaf is compared without its
leading ("layers") entries."""
import contextlib
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.launch import shardings as jsh
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.sharding import policy as jpol
from repro_torch.launch import shardings as tsh
from repro_torch.launch.mesh import dry_world, make_mesh, make_production_mesh
from repro_torch.models import lm, whisper
from repro_torch.models.registry import (WHISPER_FRAMES, ShapeSpec,
                                         get_config, get_model, list_archs)
from repro_torch.sharding import policy as pol

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _meshes(name):
    """(JAX AbstractMesh, port DeviceMesh on a dry world) of ``name``."""
    shape, axes = MESHES[name]
    with dry_world(math.prod(shape)):
        yield AbstractMesh(shape, axes), make_mesh(shape, axes, "cpu")


def _norm(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(sh, ndim=None):
    spec = tuple(_norm(e) for e in tuple(sh.spec))
    if ndim is not None:
        spec += (None,) * (ndim - len(spec))
    return spec


def _jax_flat(tree, is_leaf=None):
    """{dotted path: leaf} of a JAX tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {".".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _port_vs_jax(port_flat: dict, jax_flat: dict, jax_ndim: dict):
    """Every port leaf's spec equals its JAX leaf's without the stacked
    leading entries (one per integer in the port's name)."""
    seen = set()
    for name, sh in port_flat.items():
        keys = name.split(".")
        depth = sum(k.isdigit() for k in keys)
        jname = ".".join(k for k in keys if not k.isdigit())
        want = _spec(jax_flat[jname], jax_ndim[jname])
        assert all(e is None for e in want[:depth]), (name, want)
        assert _spec(sh) == want[depth:], (name, _spec(sh), want)
        seen.add(jname)
    assert seen == set(jax_flat)


# ---- TestPolicy (tests/test_distribution.py) -------------------------------
def test_spec_resolution_and_dedup():
    with dry_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with pol.sharding_policy(mesh):
            spec = pol.spec_for("batch", "seq", "heads", None)
            # batch -> ("pod","data") filtered to ("data",); heads -> model
            assert spec[0] in ("data", ("data",))
            assert spec[2] == "model"
            # duplicate mesh axis is dropped for later logical axes
            spec2 = pol.spec_for("kv_seq", "kv_heads")
            assert spec2[0] == "model" and spec2[1] is None


def test_missing_mesh_axes_dropped():
    with dry_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with pol.sharding_policy(mesh):
            # "pod" doesn't exist on a single-pod mesh
            assert pol.spec_for("batch")[0] in ("data", ("data",))


def test_noop_outside_context():
    x = torch.ones((4, 4))
    assert pol.shard_as(x, "batch", "embed") is x
    assert pol.shard_count("batch") == 1
    assert pol.spec_for("batch", "heads") == (None, None)


def test_divisibility_guard():
    with dry_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        sh = pol.param_sharding(mesh, ("vocab", "embed"), (7, 8))
        # vocab 7 does not divide by model 4: replicated; embed 8 by data 2
        assert sh.spec == (None, "data")
        assert [type(p).__name__ for p in sh.placements] == ["Shard",
                                                              "Replicate"]
        assert sh.placements[0].dim == 1
        assert pol.param_sharding(mesh, ("vocab", "embed"), (8, 8)).spec == \
            ("model", "data")


def test_shard_as_inside_a_policy_keeps_the_values():
    """A plain tensor is taken as replicated and redistributed to the
    guarded spec: each rank holds its chunk, the values unchanged."""
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for rank in range(8):
        with dry_world(8, rank=rank):
            mesh = make_mesh((2, 4), ("data", "model"), "cpu")
            with pol.sharding_policy(mesh):
                assert pol.shard_count("batch") == 2
                y = pol.shard_as(x, "batch", "mlp")
                # mlp -> model: 6 does not divide by 4, so replicated
                assert tuple(y.placements) == (Shard(0), Replicate())
                d = mesh.get_coordinate()[0]
                assert torch.equal(y.to_local(), x[4 * d:4 * d + 4])
                z = pol.shard_as(y, "batch", None)
                assert z is y


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("preset", list(tsh.PRESETS))
def test_spec_for_every_rule_matches_jax(mesh_name, preset):
    names = list(pol.DEFAULT_RULES)
    assert names == list(jpol.DEFAULT_RULES)
    assert pol.DEFAULT_RULES == jpol.DEFAULT_RULES
    with _meshes(mesh_name) as (jm, tm):
        rules = tsh.PRESETS[preset]
        with jpol.sharding_policy(jm, rules), pol.sharding_policy(tm, rules):
            for name in names + [None]:
                assert _spec(pol.NamedSharding(tm, pol.spec_for(name))) == \
                    _spec(jax.sharding.NamedSharding(
                        jm, jpol.spec_for(name)), 1), name
                assert pol.shard_count(name or "layers") == \
                    jpol.shard_count(name or "layers")
            # all at once: later names lose the axes earlier ones took
            got = pol.spec_for(*names)
            want = jpol.spec_for(*names)
            assert tuple(_norm(e) for e in got) == _spec(
                jax.sharding.NamedSharding(jm, want), len(names))
        # the default rules, no divisibility guard
        assert _spec(pol.named_sharding(tm, *names)) == _spec(
            jpol.named_sharding(jm, *names), len(names))


def test_presets_and_rules_are_copies():
    assert tsh.PRESETS == jsh.PRESETS
    assert tsh.TRAIN_RULES == jsh.TRAIN_RULES
    assert tsh.SERVE_RULES == jsh.SERVE_RULES
    assert tsh._CACHE_AXES == jsh._CACHE_AXES


def _port_cache(cfg):
    if cfg.family == "encdec":
        return whisper.init_cache(cfg, 8, 64, n_frames=WHISPER_FRAMES,
                                  device="meta")
    return lm.init_cache(cfg, 8, 64, device="meta")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("preset", list(tsh.PRESETS))
@pytest.mark.parametrize("arch", list_archs())
def test_sharding_trees_match_jax(arch, preset, mesh_name):
    """param_shardings, cache_shardings, batch_shardings and
    opt_shardings of every arch at full size, on the four meshes."""
    rules = tsh.PRESETS[preset]
    japi, tapi = jax_model(jax_config(arch)), get_model(get_config(arch),
                                                        device="cpu")
    cab = jax.eval_shape(lambda: japi.init_cache(8, 64))
    spec = ShapeSpec("t", 4096, 256, "train")
    with _meshes(mesh_name) as (jm, tm):
        jp = jsh.param_shardings(jm, japi, rules)
        tp = tsh.param_shardings(tm, tapi, rules)
        jnd = {k: len(v.shape) for k, v in _jax_flat(
            japi.abstract_params()).items()}
        _port_vs_jax(tsh.flatten(tp), _jax_flat(jp), jnd)
        # opt state: step replicated, m and v mirror the params
        topt = tsh.opt_shardings(tm, tp)
        assert topt.step.spec == () and all(
            p == Replicate() for p in topt.step.placements)
        assert topt.m == tsh.flatten(tp) == topt.v
        # decode caches: the same stacked layout on both sides
        jc = _jax_flat(jsh.cache_shardings(jm, cab, rules))
        tc = tsh.flatten(tsh.cache_shardings(tm, _port_cache(
            get_config(arch)), rules))
        cnd = {k: len(v.shape) for k, v in _jax_flat(cab).items()}
        assert set(tc) == set(jc)
        for k in tc:
            assert _spec(tc[k]) == _spec(jc[k], cnd[k]), k
        # batches
        jb = jsh.batch_shardings(jm, japi.input_specs(spec), rules)
        tb = tsh.batch_shardings(tm, tapi.input_specs(spec), rules)
        assert set(tb) == set(jb)
        for k in tb:
            assert _spec(tb[k]) == _spec(jb[k], len(tb[k].spec)), k


@pytest.mark.parametrize("multi_pod,shape", [(False, (16, 16)),
                                             (True, (2, 16, 16))])
def test_production_mesh(multi_pod, shape):
    with dry_world(math.prod(shape)):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type="cpu")
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
    with dry_world(8), pytest.raises(ValueError, match="256"):
        make_production_mesh(device_type="cpu")


def test_local_mesh_over_the_open_world():
    """make_local_mesh: ("data", "model") over the world's ranks, the
    model axis the largest divisor of them in ``model_parallel``."""
    from repro_torch.launch.mesh import local_world, make_local_mesh
    with local_world("cpu"):
        mesh = make_local_mesh(2, "cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    for n, mp, shape in ((8, 4, (2, 4)), (8, 3, (8, 1)), (6, 4, (3, 2))):
        with dry_world(n):
            assert tuple(make_local_mesh(mp, "cpu").shape) == shape
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((1, 1), ("data", "model"), "cpu")


@pytest.mark.parametrize("n,build", [
    (8, lambda: make_mesh((2, 4), ("data", "model"))),
    (256, lambda: make_production_mesh())], ids=["make_mesh", "production"])
def test_meshes_default_to_the_card(n, build):
    """A mesh is of the card's device type unless the caller asks for the
    CPU: without a card the default raises, as ``resolve_device`` does."""
    with dry_world(n):
        if torch.cuda.is_available():
            assert build().device_type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


def test_input_specs_match_jax():
    """The meta batches of every arch and shape cell: shapes and dtypes."""
    from repro.models.registry import LM_SHAPES as JSHAPES
    from repro.models.registry import shapes_for as jshapes_for
    from repro_torch.models.registry import LM_SHAPES, shapes_for
    assert [tuple(vars(s).values()) for s in LM_SHAPES] == \
        [tuple(vars(s).values()) for s in JSHAPES]
    dt = {np.dtype("int32"): torch.int32, np.dtype("float32"): torch.float32}
    for arch in list_archs():
        japi = jax_model(jax_config(arch))
        tapi = get_model(get_config(arch), device="cpu")
        assert [s.name for s in shapes_for(tapi.cfg)] == \
            [s.name for s in jshapes_for(japi.cfg)]
        for s, js in zip(LM_SHAPES, JSHAPES):
            got, want = tapi.input_specs(s), japi.input_specs(js)
            assert set(got) == set(want), arch
            for k in got:
                assert got[k].is_meta
                assert tuple(got[k].shape) == want[k].shape, (arch, k)
                assert got[k].dtype == dt[np.dtype(want[k].dtype)]


def test_abstract_params_allocate_nothing():
    api = get_model(get_config("qwen3-moe-235b-a22b"), device="cpu")
    leaves = list(tsh.flatten(api.abstract_params()).values())
    assert all(t.is_meta and t.dtype == torch.float32 for t in leaves)
    assert sum(t.numel() for t in leaves) == api.count_params()
    axes = tsh.flatten(api.param_axes())
    assert axes.keys() == tsh.flatten(api.abstract_params()).keys()
    assert all(len(axes[k]) == t.dim() for k, t in zip(axes, leaves))
