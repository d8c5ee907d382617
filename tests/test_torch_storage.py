"""repro_torch.core.storage against repro.core.storage: checkpoints cross
between the two packages in both directions, and the two writers produce
the same files.

Every case holds one small index, built by the JAX package from one numpy
seed and carried into the port with ``index_from_arrays`` (dot and l2, f32
and bf16, SQ8).  Integer arrays, bf16 words and file
bytes are held exactly; the one exception is the score bounds
(``bounds_*.npy``), f32 sums over D that XLA and PyTorch take in another
order: ``radius`` agrees within 4 ULP (rtol 5e-7), and ``slack``, a
difference of two such sums of size ‖x‖², within 4 ULP of the largest
‖x‖² (atol 5e-7·max‖x‖²).
"""

import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import storage as js
from repro.core import summaries as jsum
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import storage as ts
from repro_torch.core import summaries as tsum

N, D, M, KC = 900, 16, 3, 8
VARIANTS = {  # name: (metric, jax dtype, torch dtype, quantized)
    "dot-f32": ("dot", jnp.float32, torch.float32, False),
    "dot-bf16": ("dot", jnp.bfloat16, torch.bfloat16, False),
    "l2-f32": ("l2", jnp.float32, torch.float32, False),
    "l2-bf16": ("l2", jnp.bfloat16, torch.bfloat16, False),
    "sq8": ("dot", jnp.float32, torch.float32, True),
}
FIELDS = ("centroids", "vectors", "attrs", "ids", "counts", "norms", "scales")
SUMMARY_FIELDS = ("amin", "amax", "hist", "edges_lo", "edges_hi")
BOUNDS_RTOL = 5e-7


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    topic = (np.arange(N) * KC) // N
    # uneven lists: the last cluster is short, so records carry dead rows
    topic[-40:] = KC - 2
    core = centers[topic] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    return centers, core, attrs, topic.astype(np.int32)


_CACHE = {}


def _indexes(variant):
    """(jax index, port index) built once per module from the same data."""
    if variant not in _CACHE:
        metric, jd, td, quantized = VARIANTS[variant]
        centers, core, attrs, topic = _data()
        jspec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jd, metric=metric)
        tspec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=td, metric=metric)
        ji, _ = jivf.build_from_assignments(
            jspec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
            jnp.asarray(topic))
        if quantized:
            ji = jivf.quantize_index(ji)
        # the same index on both sides: the JAX index carried across
        arrays = {f: (None if getattr(ji, f) is None
                      else np.asarray(getattr(ji, f))) for f in FIELDS}
        arrays.update({f: np.asarray(getattr(ji.summaries, f))
                       for f in SUMMARY_FIELDS})
        _CACHE[variant] = ji, tivf.index_from_arrays(arrays, tspec,
                                                     device="cpu")
    return _CACHE[variant]


def _words(a):
    """An array of either package as comparable numpy (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        return ts.host_words(a)
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_index_equal(j, t):
    """A JAX index and a port index hold the same arrays."""
    for f in FIELDS:
        ja, ta = getattr(j, f), getattr(t, f)
        assert (ja is None) == (ta is None), f
        if ja is not None:
            np.testing.assert_array_equal(_words(ja), _words(ta), err_msg=f)
    assert (j.summaries is None) == (t.summaries is None)
    if j.summaries is not None:
        for f in SUMMARY_FIELDS:
            np.testing.assert_array_equal(
                _words(getattr(j.summaries, f)),
                _words(getattr(t.summaries, f)), err_msg=f)
    assert t.spec == ts.spec_from_manifest(dict(
        dim=j.spec.dim, n_attrs=j.spec.n_attrs, metric=j.spec.metric,
        core_dtype=("bfloat16" if j.spec.core_dtype == jnp.bfloat16
                    else np.dtype(j.spec.core_dtype).name)))


def _assert_bound_close(name, got, want, index):
    """Score bounds within the tolerance of the module docstring."""
    if "slack" in name:
        x2 = (index.vectors.float() ** 2).sum(-1)
        if index.scales is not None:
            x2 = x2 * index.scales ** 2
        atol, rtol = BOUNDS_RTOL * float(x2.max()), 0
    else:
        atol, rtol = 0, BOUNDS_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _cases(layouts):
    return [(v, lay) for lay in layouts for v in VARIANTS]


@pytest.mark.parametrize("variant,layout", _cases((1, 2, 3)))
def test_jax_checkpoint_loads_in_port(tmp_path, variant, layout):
    ji, _ = _indexes(variant)
    js.save_index(ji, str(tmp_path), n_shards=2, layout=layout)
    got = ts.load_index(str(tmp_path), device="cpu")
    if layout == 1 and VARIANTS[variant][1] == jnp.bfloat16:
        # the reference cannot load its own v1 bf16 shards (V2 words)
        _assert_index_equal(ji, got)
        return
    _assert_index_equal(js.load_index(str(tmp_path)), got)
    if layout >= 2:
        man = js.load_manifest(str(tmp_path))
        for path in js.shard_paths(str(tmp_path), man):
            want = js.read_shard_fields(path, man)
            mine = ts.read_shard_fields(path, ts.load_manifest(str(tmp_path)))
            assert set(want) == set(mine)
            for f in want:
                np.testing.assert_array_equal(_words(want[f]), _words(mine[f]),
                                              err_msg=f)


@pytest.mark.parametrize("variant,layout", _cases((1, 2, 3)))
def test_port_checkpoint_loads_in_jax(tmp_path, variant, layout):
    ji, ti = _indexes(variant)
    ts.save_index(ti, str(tmp_path), n_shards=2, layout=layout)
    if layout == 1 and VARIANTS[variant][1] == jnp.bfloat16:
        # the same V2 words the reference writes, which it cannot load
        with pytest.raises(TypeError, match="V2"):
            js.load_index(str(tmp_path))
        _assert_index_equal(ji, ts.load_index(str(tmp_path), device="cpu"))
        return
    _assert_index_equal(js.load_index(str(tmp_path)), ti)


@pytest.mark.parametrize("variant,layout", _cases((1, 2, 3)))
def test_writers_write_the_same_files(tmp_path, variant, layout):
    ji, ti = _indexes(variant)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    gens = np.arange(KC, dtype=np.int64) * 3 if layout == 3 else None
    js.save_index(ji, str(jdir), n_shards=2, layout=layout, version=7,
                  gens=gens)
    ts.save_index(ti, str(tdir), n_shards=2, layout=layout, version=7,
                  gens=gens)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        a, b = jdir / name, tdir / name
        if name == ts.MANIFEST:
            assert json.loads(a.read_text()) == json.loads(b.read_text())
        elif name in ts.BOUNDS_FILES.values():
            _assert_bound_close(name, np.load(b), np.load(a), ti)
        elif name.endswith(".npz"):  # zip members carry write times
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files
                for f in za.files:
                    assert za[f].dtype == zb[f].dtype, f
                    assert za[f].tobytes() == zb[f].tobytes(), f
        else:
            assert filecmp.cmp(a, b, shallow=False), name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_pad_k_and_build_bounds_match_reference(variant):
    ji, ti = _indexes(variant)
    _assert_index_equal(js.pad_k(ji, KC + 5), ts.pad_k(ti, KC + 5))
    with pytest.raises(ValueError, match="shrink"):
        ts.pad_k(ti, KC - 1)
    jb = jsum.build_bounds(ji.centroids, ji.vectors, ji.ids, ji.norms,
                           ji.scales)
    tb = tsum.build_bounds(ti.centroids, ti.vectors, ti.ids, ti.norms,
                           ti.scales)
    for f in ("radius", "slack"):
        _assert_bound_close(f, getattr(tb, f).numpy(),
                            np.asarray(getattr(jb, f)), ti)
    assert tb.nbytes() == jb.nbytes()


def test_target_shards_pads_like_reference(tmp_path):
    ji, _ = _indexes("l2-f32")
    js.save_index(ji, str(tmp_path), n_shards=2)
    _assert_index_equal(js.load_index(str(tmp_path), target_shards=3),
                        ts.load_index(str(tmp_path), target_shards=3,
                                      device="cpu"))


def _broken(tmp_path, how):
    ji, _ = _indexes("dot-f32")
    d = tmp_path / how
    js.save_index(ji, str(d), n_shards=2)
    if how == "missing shard":
        os.unlink(d / "shard_1_of_2.bin")
    elif how == "missing summaries":
        os.unlink(d / ts.SUMMARY_FILES["hist"])
    elif how == "missing gens":
        os.unlink(d / ts.GENS_FILE)
    elif how == "gens skew":
        np.save(d / ts.GENS_FILE, np.zeros(KC + 1, np.int64))
    return str(d)


@pytest.mark.parametrize("how", ["missing shard", "missing summaries",
                                 "missing gens", "gens skew"])
def test_broken_checkpoints_raise_as_in_reference(tmp_path, how):
    d = _broken(tmp_path, how)
    skew = how == "gens skew"
    with pytest.raises(js.GenerationMismatchError if skew
                       else FileNotFoundError):
        js.load_index(d)
    with pytest.raises(ts.GenerationMismatchError if skew
                       else FileNotFoundError):
        ts.load_index(d, device="cpu")
    man = ts.load_manifest(d)
    if how.startswith("gens"):  # the generation vector on its own
        with pytest.raises(js.GenerationMismatchError):
            js.load_gens(d, man)
        with pytest.raises(ts.GenerationMismatchError):
            ts.load_gens(d, man)
