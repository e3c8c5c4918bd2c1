"""The fixed-order moment sums: tpuslam_torch.kernels.lsd.segment_moments
(its plain version on the CPU) against the JAX package's sums (the one-hot
reduction of detect_lines and merge_collinear's segment_sum), and the
detector's sums reaching the three sum entries (component_moments,
component_extents, segment_moments), and nothing else, on every path."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import QVGA, image01, np_of, stereo_scene
from tpuslam_torch.kernels import lsd

PORT = pathlib.Path(__file__).resolve().parent.parent / "tpuslam_torch"


@pytest.mark.parametrize("N, K, V, seed", [(76800, 256, 7, 0), (49152, 256, 1, 1), (256, 256, 7, 2), (1000, 8, 3, 3)])
def test_segment_moments_match_jax_one_hot(N, K, V, seed):
    """Sums by slot (the dump slot K included) within 1e-5 relative of the
    JAX package's fused one-hot reduction, the form of detect_lines' `red`."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, K + 1, N).astype(np.int32)
    slot[: N // 2] = K  # most items in the dump slot, as the detector's non-support pixels
    vals = rng.normal(0.0, 50.0, (V, N)).astype(np.float32)
    got = np_of(lsd.segment_moments(torch.from_numpy(vals), torch.from_numpy(slot), K + 1))

    @jax.jit
    def red(v, s):
        eq = (s[None, :] == jnp.arange(K + 1)[:, None]).astype(jnp.float32)
        return jnp.stack([jnp.sum(eq * row[None, :], axis=1) for row in v])

    ref = np.asarray(red(jnp.asarray(vals), jnp.asarray(slot)))
    assert got.shape == (V, K + 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(vals).sum(axis=1, keepdims=True).max() / N * 10)


def test_segment_moments_match_jax_segment_sum():
    """merge_collinear's form: K items grouped by label, against
    jax.ops.segment_sum, within 1e-5 relative."""
    rng = np.random.default_rng(4)
    K = 256
    labels = np.minimum(rng.integers(0, K, K), np.arange(K)).astype(np.int32)
    vals = rng.uniform(0.0, 400.0, (7, K)).astype(np.float32)
    got = np_of(lsd.segment_moments(torch.from_numpy(vals), torch.from_numpy(labels), K))
    ref = np.stack([np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(labels), K)) for v in vals])
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_detector_sums_only_through_segment_moments(monkeypatch):
    """detect_lines (with merge_collinear) reaches its float sums through
    the three sum entries only, once each per call: component_moments (the
    seven moments of the K components), component_extents (their extents
    and normal moment) and segment_moments (the merge's 7 columns);
    index_add_ runs only inside segment_moments_torch, the plain sums, which
    a CUDA tensor never reaches."""
    _, frames = stereo_scene(1, QVGA)
    img = torch.from_numpy(image01(frames[0][0]))
    calls, inside = [], []
    real = {name: getattr(lsd, name) for name in lsd.SUMS}
    real_twin, real_add = lsd.segment_moments_torch, torch.Tensor.index_add_

    def recorder(name):
        def call(first, *rest):
            calls.append((name, tuple(first.shape), rest[-1] if name == "segment_moments" else rest[2].numel()))
            return real[name](first, *rest)

        return call

    def twin(values, slot, S):
        inside.append(1)
        try:
            return real_twin(values, slot, S)
        finally:
            inside.pop()

    def index_add_(self, *a, **k):
        assert inside, "index_add_ outside segment_moments_torch"
        return real_add(self, *a, **k)

    for name in lsd.SUMS:
        monkeypatch.setattr(lsd, name, recorder(name))
    monkeypatch.setattr(lsd, "segment_moments_torch", twin)
    monkeypatch.setattr(torch.Tensor, "index_add_", index_add_)
    det = lsd.detect_lines(img, 256)
    H, W = img.shape
    K = 256
    assert calls == [("component_moments", (H, W), K), ("component_extents", (H, W), K), ("segment_moments", (7, K), K)]
    assert float(det.valid.sum()) > 20


def _code_lines(path: pathlib.Path):
    """(line number, code) of a Python file, comments and docstrings dropped."""
    import ast
    import io
    import tokenize

    src = path.read_text()
    doc_lines = set()
    for node in ast.walk(ast.parse(src)):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and isinstance(getattr(body[0], "value", None), ast.Constant) and isinstance(body[0].value.value, str):
            doc_lines.update(range(body[0].lineno, body[0].end_lineno + 1))
    out = {}
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type in (tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE) or tok.start[0] in doc_lines:
            continue
        out.setdefault(tok.start[0], []).append(tok.string)
    return [(n, " ".join(t)) for n, t in sorted(out.items())]


def test_index_add_only_in_the_plain_moments():
    """No code of the port calls index_add_ except segment_moments_torch,
    the CPU-only plain sums behind segment_moments, component_moments_torch
    and component_extents_torch (the plain versions of the three sum
    kernels)."""
    hits = []
    for path in sorted(PORT.rglob("*.py")):
        for n, code in _code_lines(path):
            if "index_add_" in code:
                hits.append(f"{path.relative_to(PORT.parent)}:{n}")
    src = (PORT / "kernels" / "lsd.py").read_text().splitlines()
    twin = next(i for i, line in enumerate(src, 1) if line.startswith("def segment_moments_torch"))
    assert hits == [f"tpuslam_torch/kernels/lsd.py:{twin + 4}"], hits


@pytest.mark.parametrize("root", ["tpuslam_torch", "chip_smoke.py"])
def test_port_imports_neither_jax_nor_tpuslam(root):
    """The port's modules and chip_smoke.py import no jax and nothing of
    the JAX package (only the tests import both)."""
    base = PORT.parent / root
    bad = []
    for path in sorted(base.rglob("*.py")) if base.is_dir() else [base]:
        for n, code in _code_lines(path):
            if re.match(r"(import|from) (jax|jaxlib|tpuslam)\b(?!_torch)", code.replace(" . ", ".")):
                bad.append(f"{path.name}:{n}: {code}")
    assert not bad, bad
