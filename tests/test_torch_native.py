"""The native map store: tpuslam_torch.slammap.native against the JAX
package's library and against the python graph.

``tests/test_native.py``'s six cases run on this package's
``NativeMapStore``; then every query of this package's library
(``tpuslam_torch/csrc/mapstore.cpp``) is held to a library built from the
JAX package's ``native/mapstore.cpp`` (into a temporary directory, never
``native/build/``) over randomized operation sequences, covisibility order
included; ``SlamMap`` with the mirror to the python graph; loaded maps, the
capacity fallback and concurrent builds.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import jax_native_library
from tpuslam_torch.frontend.frame import FrameFeatures
from tpuslam_torch.slammap import native
from tpuslam_torch.slammap.map import MapLineStore, SlamMap
from tpuslam_torch.slammap.native import NativeMapStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def features(K: int) -> FrameFeatures:
    return FrameFeatures(
        endpoints=np.zeros((K, 2, 2), np.float32),
        valid=np.ones(K, np.float32),
        angle=np.zeros(K, np.float32),
        length=np.zeros(K, np.float32),
        midpoint=np.zeros((K, 2), np.float32),
        response=np.zeros(K, np.float32),
        level=np.zeros(K, np.int32),
        sigma=np.ones(K, np.float32),
        desc=np.zeros((K, 72), np.float32),
        desc_bits=np.zeros((K, 8), np.uint32),
        depth=np.zeros((K, 2), np.float32),
        has_depth=np.zeros(K, np.float32),
    )


# ---- tests/test_native.py's cases ------------------------------------------


def test_basic_lifecycle():
    s = NativeMapStore(line_capacity=64, kf_capacity=8, feat_capacity=16)
    for k in range(3):
        s.add_keyframe(k)
    a = s.allocate(0)
    b = s.allocate(0)
    assert a != b and s.alive(a) and s.alive(b)
    assert s.add_observation(a, 0, 2)
    assert s.add_observation(a, 1, 3)
    assert s.add_observation(b, 1, 4)
    assert s.n_obs(a) == 2
    assert list(s.line_ids(1)[:5]) == [-1, -1, -1, a, b]
    kids, counts = s.covisibility(0)
    assert list(kids) == [1] and list(counts) == [1]
    assert sorted(s.window_lines([0, 1])) == sorted([a, b])
    li, kk, ss = s.observations(np.asarray([a, b]))
    assert len(li) == 3
    s.erase_observation(a, 1)
    assert s.n_obs(a) == 1
    s.kill(b)
    assert not s.alive(b)
    assert s.line_ids(1)[4] == -1


def test_replace_fusion():
    s = NativeMapStore(line_capacity=16, kf_capacity=4, feat_capacity=8)
    for k in range(3):
        s.add_keyframe(k)
    old = s.allocate(0)
    new = s.allocate(1)
    s.add_observation(old, 0, 1)
    s.add_observation(old, 1, 2)
    s.add_observation(new, 1, 3)
    s.add_observation(new, 2, 4)
    s.replace(old, new)
    assert not s.alive(old)
    # kf0's slot now points at new; kf1 keeps its own binding of new
    assert s.line_ids(0)[1] == new
    assert s.line_ids(1)[3] == new
    assert s.line_ids(1)[2] == -1
    assert s.n_obs(new) == 3


def test_randomized_parity_with_python_store(rng):
    """The same operation trace through the native store and the python
    line store (no mirror): the same ids, observations and covisibility."""
    F = 12
    nat = NativeMapStore(line_capacity=256, kf_capacity=16, feat_capacity=F)
    smap = SlamMap(line_capacity=256, native=False)
    kfs = {}
    lids = []
    for k in range(8):
        kfs[k] = smap.new_keyframe(k, 0.0, np.eye(4, dtype=np.float32), features(F))
        nat.add_keyframe(k)
    for _ in range(200):
        op = rng.integers(0, 5)
        if op == 0 or not lids:
            k = int(rng.integers(0, 8))
            slot = int(rng.integers(0, F))
            if kfs[k].line_ids[slot] >= 0:
                continue
            lp = smap.lines.allocate(np.zeros(6, np.float32), np.zeros((2, 3), np.float32), np.zeros(8, np.uint32), k)
            ln = nat.allocate(k)
            assert lp == ln
            smap.lines.add_observation(lp, kfs[k], slot)
            nat.add_observation(ln, k, slot)
            lids.append(lp)
        elif op == 1:
            lid = int(rng.choice(lids))
            k = int(rng.integers(0, 8))
            slot = int(rng.integers(0, F))
            if not smap.lines.alive[lid] or kfs[k].line_ids[slot] >= 0 or k in smap.lines.obs.get(lid, {}):
                continue
            smap.lines.add_observation(lid, kfs[k], slot)
            nat.add_observation(lid, k, slot)
        elif op == 2:
            lid = int(rng.choice(lids))
            k = int(rng.integers(0, 8))
            smap.lines.erase_observation(lid, kfs[k])
            nat.erase_observation(lid, k)
        elif op == 3:
            lid = int(rng.choice(lids))
            if smap.lines.alive[lid]:
                smap.lines.kill(lid, smap.keyframes)
                nat.kill(lid)
        else:
            if len(lids) < 2:
                continue
            a, b = (int(x) for x in rng.choice(lids, 2, replace=False))
            if a == b or not (smap.lines.alive[a] and smap.lines.alive[b]):
                continue
            smap.lines.replace(a, b, smap.keyframes)
            nat.replace(a, b)
    for lid in set(lids):
        assert bool(smap.lines.alive[lid]) == nat.alive(lid), lid
        if smap.lines.alive[lid]:
            assert int(smap.lines.n_obs[lid]) == nat.n_obs(lid), lid
    for k in range(8):
        assert np.array_equal(kfs[k].line_ids, nat.line_ids(k)), k
    for k in range(8):
        smap.update_connections(kfs[k])
        kids, counts = nat.covisibility(k)
        assert dict(zip(kids.tolist(), counts.tolist())) == smap.covis[k], k


def test_replace_overflow_clears_stale_slot():
    """A full observation list on the surviving id: replace still clears the
    keyframe slot that pointed at the dying one."""
    s = NativeMapStore(line_capacity=128, kf_capacity=64, feat_capacity=8)
    for k in range(40):
        s.add_keyframe(k)
    new = s.allocate(0)
    for k in range(32):
        assert s.add_observation(new, k, 1)
    old = s.allocate(33)
    assert s.add_observation(old, 33, 2)
    s.replace(old, new)
    assert not s.alive(old)
    assert s.line_ids(33)[2] == -1
    fresh = s.allocate(34)
    assert s.line_ids(33)[2] == -1 and fresh >= 0


def test_add_observation_rebind_clears_previous_slot():
    s = NativeMapStore(line_capacity=16, kf_capacity=4, feat_capacity=8)
    s.add_keyframe(0)
    a = s.allocate(0)
    assert s.add_observation(a, 0, 2)
    assert s.add_observation(a, 0, 5)
    ids = s.line_ids(0)
    assert ids[5] == a and ids[2] == -1
    assert s.n_obs(a) == 1


def random_map_ops(maps, rng, steps: int = 8, K: int = 32):
    """Drive SlamMaps through the same allocate / observe / update /
    kill / replace / cull sequence (tests/test_native.py's)."""
    lids: list = []
    for step in range(steps):
        kfs = [m.new_keyframe(step, float(step), np.eye(4, dtype=np.float32), features(K)) for m in maps]
        slots = rng.permutation(K)[:12]
        pool = list(dict.fromkeys(lids))
        rng.shuffle(pool)
        for si, lid in zip(slots, pool[:12]):
            for m, kf in zip(maps, kfs):
                if m.lines.alive[lid]:
                    m.lines.add_observation(lid, kf, int(si))
        for si in rng.permutation(K)[:6]:
            if kfs[0].line_ids[si] >= 0:
                continue
            new_ids = [m.lines.allocate(np.zeros(6), np.zeros((2, 3)), np.zeros(8, np.uint32), kfs[0].kid) for m in maps]
            assert len(set(new_ids)) == 1
            lids.append(new_ids[0])
            for m, kf in zip(maps, kfs):
                m.lines.add_observation(new_ids[0], kf, int(si))
        for m, kf in zip(maps, kfs):
            m.update_connections(kf)
        if lids and step % 2 == 1:
            victim = int(lids[int(rng.integers(0, len(lids)))])
            for m in maps:
                m.lines.kill(victim, m.keyframes)
        if len(lids) > 4 and step % 3 == 2:
            a, b = (int(lids[i]) for i in rng.integers(0, len(lids), 2))
            for m in maps:
                if m.lines.alive[a] and m.lines.alive[b] and a != b:
                    m.lines.replace(a, b, m.keyframes)
        if step == 5:
            for m in maps:
                m.erase_keyframe(2)
    return lids


def test_slammap_native_mirror_covisibility_parity(rng):
    """SlamMap with the native mirror makes the covisibility rows and
    spanning tree of the python graph over a randomized sequence."""
    maps = [SlamMap(line_capacity=256, native=True), SlamMap(line_capacity=256, native=False)]
    assert maps[0].lines.mirror is not None and maps[1].lines.mirror is None
    random_map_ops(maps, rng)
    assert maps[0].lines.mirror is not None, "mirror dropped mid-sequence"
    for kid in maps[1].keyframes:
        assert maps[0].covis.get(kid, {}) == maps[1].covis.get(kid, {}), kid
        assert maps[0].keyframes[kid].parent == maps[1].keyframes[kid].parent


# ---- against the JAX package's library -------------------------------------


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """tpuslam.slammap.native with its library loaded (built from
    native/mapstore.cpp into a temporary directory where this process has
    not loaded it yet)."""
    with jax_native_library(tmp_path_factory.mktemp("jax_native")) as jn:
        yield jn


def _queries(store, kids, lines):
    out = dict(
        alive=[store.alive(l) for l in lines],
        n_obs=[store.n_obs(l) for l in lines],
        line_ids=[store.line_ids(k).tolist() for k in kids],
        window=store.window_lines(kids).tolist(),
        observations=[x.tolist() for x in store.observations(np.asarray(lines, np.int32))],
    )
    for w in (1, 2):  # covisibility in the library's order, ties included
        out[f"covis{w}"] = [[x.tolist() for x in store.covisibility(k, min_weight=w)] for k in kids]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_library_matches_jax_library(jax_native, seed):
    """Every query of this package's library equals the JAX package's over
    a randomized sequence of every mutation (allocate, observe, re-bind,
    erase, kill, replace, keyframe removal), covisibility order included:
    with few keyframes and many shared lines, counts tie often."""
    rng = np.random.default_rng(seed)
    F, n_kf = 24, 12
    ours = NativeMapStore(line_capacity=512, kf_capacity=32, feat_capacity=F)
    theirs = jax_native.NativeMapStore(line_capacity=512, kf_capacity=32, feat_capacity=F)
    stores = (ours, theirs)
    lids: list = []
    for k in range(n_kf):
        for s in stores:
            s.add_keyframe(k)
    n_ties = 0
    for step in range(600):
        op = int(rng.integers(0, 8))
        lid = int(rng.choice(lids)) if lids else -1
        k, slot = int(rng.integers(0, n_kf)), int(rng.integers(0, F))
        if op <= 1 or lid < 0:
            got = [s.allocate(k) for s in stores]
            assert got[0] == got[1]
            lids.append(got[0])
            assert ours.add_observation(got[0], k, slot) == theirs.add_observation(got[0], k, slot)
        elif op <= 3:
            assert ours.add_observation(lid, k, slot) == theirs.add_observation(lid, k, slot)
        elif op == 4:
            for s in stores:
                s.erase_observation(lid, k)
        elif op == 5:
            for s in stores:
                s.kill(lid)
        elif op == 6:
            other = int(rng.choice(lids))
            for s in stores:
                s.replace(lid, other)
        elif rng.random() < 0.1:
            for s in stores:
                s.remove_keyframe(k)
        if step % 60 == 59:
            a, b = _queries(ours, list(range(n_kf)), lids), _queries(theirs, list(range(n_kf)), lids)
            assert a == b, step
            n_ties += sum(len(c) != len(set(c)) for _, c in a["covis1"])
    assert n_ties > 0  # the orders compared include ties


def test_slammap_mirror_matches_jax_mirror(jax_native, rng):
    """This package's SlamMap and the JAX package's, both with their mirror,
    through the same randomized sequence: the same covisibility rows in the
    same order (the mirror's), and the same spanning tree."""
    from tpuslam.slammap.map import SlamMap as JSlamMap

    ours, theirs = SlamMap(line_capacity=256, native=True), JSlamMap(line_capacity=256, native=True)
    assert theirs.lines.mirror is not None
    random_map_ops([ours, theirs], rng, steps=10)
    assert ours.lines.mirror is not None and theirs.lines.mirror is not None
    for kid in theirs.keyframes:
        assert list(ours.covis[kid].items()) == list(theirs.covis[kid].items()), kid
        assert ours.keyframes[kid].parent == theirs.keyframes[kid].parent
        assert ours.covisible_keyframes(kid) == theirs.covisible_keyframes(kid)


# ---- SlamMap's rules --------------------------------------------------------


def test_mirror_switch(monkeypatch):
    """TPUSLAM_NATIVE_MAP: "1" (and unset) gives a mirror, "0" none; an
    explicit ``native`` wins."""
    monkeypatch.delenv("TPUSLAM_NATIVE_MAP", raising=False)
    assert SlamMap().lines.mirror is not None
    monkeypatch.setenv("TPUSLAM_NATIVE_MAP", "0")
    assert SlamMap().lines.mirror is None
    assert SlamMap(native=True).lines.mirror is not None
    monkeypatch.setenv("TPUSLAM_NATIVE_MAP", "1")
    assert SlamMap(native=False).lines.mirror is None


def test_mirror_that_cannot_build_raises(monkeypatch, tmp_path):
    """A mirror asked for whose library does not build raises, naming the
    switch that turns it off (the JAX map falls back silently)."""
    bad = tmp_path / "mapstore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="TPUSLAM_NATIVE_MAP=0"):
            SlamMap(native=True)
    finally:
        native.library.cache_clear()


def test_loaded_map_has_no_mirror(rng, tmp_path):
    """A map loaded from a file, or carried across from a snapshot, uses the
    python graph (its stores are restored array by array)."""
    from tpuslam_torch.convert import map_state, slam_map_from
    from tpuslam_torch.slammap.serialize import load_map, save_map

    m = SlamMap(line_capacity=256)
    random_map_ops([m], rng, steps=4)
    save_map(m, str(tmp_path / "map.npz"))
    loaded = load_map(str(tmp_path / "map.npz"))
    assert loaded.lines.mirror is None and slam_map_from(map_state(m)).lines.mirror is None
    assert loaded.covis == m.covis


@pytest.mark.parametrize("over", ["keyframes", "features"])
def test_capacity_fallback(over):
    """A keyframe beyond the mirror's keyframe or feature capacity drops the
    mirror (python from then on), as the JAX map does; the counts stay
    right."""
    m = SlamMap(line_capacity=64, native=True)
    m.lines.mirror = NativeMapStore(line_capacity=64, kf_capacity=2, feat_capacity=16)
    K = 16 if over == "keyframes" else 17
    a = m.new_keyframe(0, 0.0, np.eye(4, dtype=np.float32), features(K if over == "keyframes" else 16))
    lid = m.lines.allocate(np.zeros(6), np.zeros((2, 3)), np.zeros(8, np.uint32), a.kid)
    m.lines.add_observation(lid, a, 3)
    assert m.lines.mirror is not None
    b = m.new_keyframe(1, 0.1, np.eye(4, dtype=np.float32), features(16))
    m.lines.add_observation(lid, b, 5)
    assert m.lines.mirror is not None
    c = m.new_keyframe(2, 0.2, np.eye(4, dtype=np.float32), features(K))
    assert m.lines.mirror is None
    m.lines.add_observation(lid, c, 1)
    m.update_connections(c)
    assert m.covis[c.kid] == {a.kid: 1, b.kid: 1}


def test_line_capacity_mismatch_drops_mirror():
    """A mirror whose ids leave the python store's (a smaller line
    capacity) is dropped at the first allocation that disagrees."""
    st = MapLineStore(capacity=8)
    st.mirror = NativeMapStore(line_capacity=1, kf_capacity=4, feat_capacity=8)
    st.allocate(np.zeros(6), np.zeros((2, 3)), np.zeros(8, np.uint32), 0)
    assert st.mirror is not None
    st.allocate(np.zeros(6), np.zeros((2, 3)), np.zeros(8, np.uint32), 0)
    assert st.mirror is None


def test_keyframe_ids_out_of_range_raise():
    """The queries that read a keyframe's slot row refuse an id beyond the
    keyframe capacity (the library does not check it)."""
    s = NativeMapStore(line_capacity=8, kf_capacity=4, feat_capacity=8)
    s.add_keyframe(3)
    assert s.line_ids(3).tolist() == [-1] * 8
    for bad in (4, -1):
        with pytest.raises(IndexError):
            s.line_ids(bad)
        with pytest.raises(IndexError):
            s.covisibility(bad)
        with pytest.raises(IndexError):
            s.window_lines([0, bad])


BUILD_AND_LOAD = """
import sys
from pathlib import Path
from tpuslam_torch.slammap import native
lib = native.library(Path(sys.argv[1]))
h = lib.ms_create(8, 2, 4)
lib.ms_add_keyframe(h, 0)
assert lib.ms_allocate(h, 0) == 0
lib.ms_destroy(h)
print("loaded", flush=True)
"""


def test_concurrent_builds_both_load(tmp_path):
    """Two processes building into one fresh build directory at once: both
    load a whole library (the lock, the temporary file and the rename)."""
    d = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, "-c", BUILD_AND_LOAD, str(d)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err
    assert sorted(x.name for x in d.iterdir()) == ["libmapstore.so", "mapstore.lock"]
