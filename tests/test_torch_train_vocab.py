"""Vocabulary training of the port (`lmono_tpu_torch/train_vocab.py`) against
the JAX package's script (`examples/train_vocab.py`, loaded from its file).

Tolerances: harvested descriptors ±1 exactly, the same count per view and
at least 99% of each view's rows found bitwise among the reference's rows
of that view (two corners of equal response may come out in either order);
spherical k-means with the reference's reseed draws (its JAX key chain,
passed as `reseed_idx`): the same assignments and counts at every
iteration, centroids and mean cosine within 1e-5 (f32 matmuls and norms in
another order); the hierarchical tree's leaves within 1e-5.
"""

import functools
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from lmono_tpu_torch import train_vocab as tv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_train_vocab", os.path.join(ROOT, "examples", "train_vocab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _reference_harvest(views, kp):
    from lmono_tpu.config import synthetic_config

    return _reference().harvest(views, kp, synthetic_config().camera)


def _jax_reseed_draws(seed, iters, k, n):
    """The reseed indices the reference draws: randint over its split key
    chain, one (k,) draw an iteration."""
    import jax

    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iters):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(k1, (k,), 0, n)))
    return torch.from_numpy(np.stack(out).astype(np.int64))


def _clustered(seed=0, n=3000, protos=12, flip=0.2, dup=0.0):
    """±1 rows around `protos` random prototypes, each bit flipped with
    probability `flip`; a share `dup` of the rows are copies of one row
    (as flat image patches repeat a descriptor), shuffled in."""
    rng = np.random.default_rng(seed)
    P = np.where(rng.random((protos, 256)) < 0.5, -1.0, 1.0)
    X = P[rng.integers(0, protos, n)]
    X = np.where(rng.random(X.shape) < flip, -X, X)
    X[:int(dup * n)] = X[-1]
    return X[rng.permutation(n)].astype(np.float32)


def test_harvest_matches(capsys):
    from lmono_tpu_torch.config import synthetic_config

    views, kp = 2, 50
    ref = _reference_harvest(views, kp)
    capsys.readouterr()
    X = tv.harvest(views, kp, synthetic_config().camera, device="cpu")
    printed = capsys.readouterr().out
    assert X.dtype == torch.float32 and set(np.unique(X.numpy())) <= {-1.0, 1.0}
    # the count after view 0 (printed at every 40th view) and the total
    n0 = int(printed.split("view 0/2: ")[1].split()[0])
    assert X.shape == ref.shape and 0 < n0 < len(X)
    X = X.numpy()
    agree = 0
    for lo, hi in ((0, n0), (n0, len(X))):
        ref_rows = {r.tobytes() for r in ref[lo:hi]}
        agree += sum(r.tobytes() in ref_rows for r in X[lo:hi])
    assert agree >= 0.99 * len(X)


def test_spherical_kmeans_matches_every_iteration():
    import jax.numpy as jnp

    # copies of one row among the initial centroids leave all but the first
    # of them empty (argmax ties go to the first index in both packages)
    ref = _reference()
    X = _clustered(dup=0.3)
    k, iters, seed = 16, 6, 0
    draws = _jax_reseed_draws(seed, iters, k, len(X))
    Xt = torch.from_numpy(X)
    init = X[np.random.RandomState(seed).choice(len(X), k, replace=False)].T
    C_prev_ref = init / np.maximum(np.linalg.norm(init, axis=0, keepdims=True), 1e-6)
    C_prev = torch.from_numpy(C_prev_ref.copy())
    reseeded = 0
    for i in range(1, iters + 1):
        C_ref, sim_ref, occ_ref = ref.spherical_kmeans(X, k, i, seed=seed)
        C, sim, occ = tv.spherical_kmeans(Xt, k, i, seed=seed, reseed_idx=draws[:i])
        # iteration i's assignments, each package's own argmax
        a_ref = np.asarray(jnp.argmax(jnp.asarray(X) @ jnp.asarray(C_prev_ref), axis=1))
        a = torch.argmax(Xt @ C_prev, dim=1).numpy()
        np.testing.assert_array_equal(a, a_ref)
        cnt = np.bincount(a, minlength=k)
        reseeded += int((cnt == 0).sum())
        assert occ == occ_ref == (cnt > 0).mean()
        np.testing.assert_allclose(C.numpy(), C_ref, rtol=0, atol=ATOL)
        assert abs(sim - sim_ref) <= ATOL
        C_prev, C_prev_ref = C, C_ref
    # the data leaves centroids empty, so the reseed path runs
    assert reseeded > 0


def test_spherical_kmeans_default_draws_run():
    X = torch.from_numpy(_clustered(1, n=600))
    C, sim, occ = tv.spherical_kmeans(X, 8, 3, seed=4)
    # ±1 rows of norm 16: the "mean cos" is the mean best projection
    assert C.shape == (256, 8) and 0.0 < sim <= 16.0 and 0.0 < occ <= 1.0
    np.testing.assert_allclose(torch.linalg.vector_norm(C, dim=0).numpy(), 1.0,
                               rtol=1e-5)


def test_hierarchical_kmeans_matches(monkeypatch):
    # the port's k-means nodes take the reference's reseed draws for their
    # seeds, so that every node can be held to the reference's
    ref = _reference()
    X = _clustered(2, n=2000, protos=9)
    plain = tv.spherical_kmeans

    def with_jax_draws(Xs, k, iters, seed=0, reseed_idx=None):
        return plain(Xs, k, iters, seed=seed,
                     reseed_idx=_jax_reseed_draws(seed, iters, k, len(Xs)))

    monkeypatch.setattr(tv, "spherical_kmeans", with_jax_draws)
    C_ref, sim_ref, occ_ref = ref.hierarchical_kmeans(X, 3, 2, 5)
    C, sim, occ = tv.hierarchical_kmeans(torch.from_numpy(X), 3, 2, 5)
    assert C.shape == C_ref.shape == (256, 9)
    np.testing.assert_allclose(C.numpy(), C_ref, rtol=0, atol=ATOL)
    assert abs(sim - sim_ref) <= ATOL and occ == occ_ref


def _tree_digest(path):
    h = hashlib.sha256()
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()


def test_main_writes_a_codebook_make_codebook_loads(tmp_path, monkeypatch):
    from lmono_tpu_torch.ops import brief

    assets = os.path.join(ROOT, "lmono_tpu_torch", "assets")
    before = _tree_digest(assets)
    out = str(tmp_path / "vocab.npz")
    res = tv.main(["--views", "2", "--kp-per-view", "50", "--branch", "2",
                   "--levels", "2", "--iters", "3", "--device", "cpu",
                   "--out", out])
    assert _tree_digest(assets) == before
    with np.load(out) as f:
        assert f["codebook"].dtype == np.float32 and f["codebook"].shape == (256, 4)
        assert f["meta"].dtype == np.int64
        assert f["meta"].tolist() == [len(res["descriptors"]), 2, 3]
    # make_codebook's loader, pointed at the written file
    monkeypatch.setattr(brief, "SHIPPED_VOCABS", brief.SHIPPED_VOCABS + ((256, 4),))
    monkeypatch.setattr(brief, "vocab_asset_path", lambda bits, dim: out)
    C = brief.make_codebook(256, 4)
    assert torch.equal(C, res["codebook"])


def test_main_takes_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tv.main(["--views", "1", "--out", os.devnull])


def test_bench_loop_pr_takes_a_trained_codebook():
    from lmono_tpu_torch import bench_loop_pr
    from lmono_tpu_torch.ops.brief import make_codebook

    C = make_codebook(256, 1000)
    out = bench_loop_pr.run(3, device="cpu", codebook=C[:, torch.randperm(1000)])
    assert out["keyframes"] == 3 and out["vocab_dim"] == 1000
    with pytest.raises(ValueError, match="codebook shape"):
        bench_loop_pr.run(3, device="cpu", codebook=C[:, :128])
