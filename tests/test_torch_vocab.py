"""The vocabulary and sparse BoW of the port against the JAX package.

Same seeded numpy inputs through both packages on the CPU.  Bounds:

- the packed tree (``pack_centers``): ``orb.pack_bits``'s layout (and the
  JAX package's), level by level at its offsets, unpacking to the tables
  again; a 0 or a 2 entry refused with its level and row;
- word ids exactly equal: the port's single route (``_descend``, and its
  kernel's plain version ``_descend_packed_plain`` on packed words)
  against the JAX ``_descend`` on random +-1 tables at k = 9, L = 5 (level
  4, 59,049 rows, the JAX deep gather route) with every ninth descriptor
  invalid, at ``upto`` = L and below; on constructed ties (duplicate
  sibling rows, all-zero descriptors) against the JAX dense masked-argmax
  and deep routes in turn; and in the lane-flattened form;
- ``train_batched``: centers exactly equal to the JAX trainer's when both
  start from the same initial centers (the draws differ: torch cannot
  reproduce JAX keys), and the same TF-IDF weights within 1e-6;
- sparse BoW: word lists equal, weights within 1e-6 (L1 norms summed in
  another order); binned histograms within 1e-6; the bf16 binned scores
  within one bf16 step of the score (8e-3 relative); exact
  min-intersection scores within 1e-6;
- ``vocab_from_numpy`` and the npz layout round-trip exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.models import vocab as jvocab
from ros_stereo_slam_tpu.ops import orb as jorb
from ros_stereo_slam_tpu_torch.models import convert, vocab
from ros_stereo_slam_tpu_torch.ops import orb


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signs(rng, shape, dtype=np.float32):
    return rng.choice(np.array([-1, 1], dtype), size=shape)


def _tables(rng, k, levels):
    return [_signs(rng, (k ** (l + 1), 256), np.int8) for l in range(levels)]


def _packed_query(q):
    """Sign rows -> (packed words, valid) as ORB hands them over."""
    qt = torch.from_numpy(q)
    return orb.pack_bits(qt > 0), (qt != 0).any(1)


def test_pack_centers_layout_and_round_trip():
    rng = np.random.default_rng(4)
    k, L = 3, 4
    tabs = _tables(rng, k, L)
    tree = vocab.pack_centers([torch.from_numpy(t) for t in tabs], k)
    assert tree.offsets == (0, 3, 12, 39, 120) and tree.levels == L
    assert tree.words.shape == (120, 8) and tree.words.dtype == torch.int32
    for l, t in enumerate(tabs):
        rows = tree.words[tree.offsets[l]:tree.offsets[l + 1]]
        assert torch.equal(rows, orb.pack_bits(torch.from_numpy(t) > 0))
        np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                      np.asarray(jorb.pack_bits(jnp.asarray(t > 0))))
        back = torch.where(orb.unpack_bits(rows), 1, -1).to(torch.int8)
        np.testing.assert_array_equal(back.numpy(), t)
    # bit j of word w is component 32 w + j
    one = np.full((k, 256), -1, np.int8)
    one[1, 32 * 5 + 7] = 1
    w = vocab.pack_centers([torch.from_numpy(one)], k).words
    assert w[1, 5].item() == 1 << 7 and int(w.abs().sum()) == 1 << 7


@pytest.mark.parametrize("entry", [0, 2])
def test_pack_centers_refuses_non_signs(entry):
    rng = np.random.default_rng(5)
    k = 3
    tabs = _tables(rng, k, 3)
    tabs[2][17, 200] = entry
    with pytest.raises(ValueError, match=rf"level 2 row 17: entry {entry} "):
        vocab.pack_centers([torch.from_numpy(t) for t in tabs], k)
    voc = vocab.Vocabulary(k=k, levels=3, centers=[torch.from_numpy(t) for t in tabs],
                           idf=torch.ones(k ** 3))
    with pytest.raises(ValueError, match="level 2 row 17"):
        vocab.transform_words(voc, torch.from_numpy(_signs(rng, (4, 256))))


def test_descend_refuses_mixed_rows():
    rng = np.random.default_rng(6)
    k = 3
    tabs = [torch.from_numpy(t) for t in _tables(rng, k, 2)]
    q = _signs(rng, (8, 256))
    q[3] = 0.0  # an invalid feature: fine
    assert vocab._descend(tabs, torch.from_numpy(q), k, 2)[3].item() == 0
    q[5, 10] = 0.0  # a feature with one zero component is not a sign row
    with pytest.raises(ValueError, match="row 5"):
        vocab._descend(tabs, torch.from_numpy(q), k, 2)


def test_descend_word_ids_equal_k9_l5():
    rng = np.random.default_rng(0)
    k, L = 9, 5
    tabs = _tables(rng, k, L)
    q = _signs(rng, (256, 256))
    q[::9] = 0.0  # invalid features
    wj = np.asarray(jvocab._descend([jnp.asarray(t) for t in tabs], jnp.asarray(q), k, L))
    wt = vocab._descend([torch.from_numpy(t) for t in tabs], torch.from_numpy(q), k, L)
    np.testing.assert_array_equal(wt.numpy(), wj)
    tree = vocab.pack_centers([torch.from_numpy(t) for t in tabs], k)
    wp = vocab._descend_packed_plain(*_packed_query(q), tree, k, L)
    np.testing.assert_array_equal(wp.numpy(), wj)
    assert wj.max() >= k ** 4  # the deep level was reached
    np.testing.assert_array_equal(wt.numpy()[::9], 0)  # zero rows: child 0 every level


@pytest.mark.parametrize("upto", [1, 3])
def test_descend_upto_below_depth(upto):
    """Node ids at a level above the leaves, from the int8 tables (only the
    first `upto` are packed) and from the whole packed tree."""
    rng = np.random.default_rng(10 + upto)
    k, L = 9, 5
    tabs = _tables(rng, k, L)
    q = _signs(rng, (200, 256))
    q[::9] = 0.0
    wj = np.asarray(jvocab._descend([jnp.asarray(t) for t in tabs], jnp.asarray(q), k, upto))
    wt = vocab._descend([torch.from_numpy(t) for t in tabs], torch.from_numpy(q), k, upto)
    np.testing.assert_array_equal(wt.numpy(), wj)
    tree = vocab.pack_centers([torch.from_numpy(t) for t in tabs], k)
    np.testing.assert_array_equal(vocab._descend(tree, torch.from_numpy(q), k, upto).numpy(), wj)
    wp = vocab._descend_packed_plain(*_packed_query(q), tree, k, upto)
    np.testing.assert_array_equal(wp.numpy(), wj)
    assert wj.max() < k ** upto


def test_descend_lane_flattened():
    """Two lanes of descriptors descend as one (B N, 8) batch: each lane's
    words are its own descent's, and the JAX package's."""
    rng = np.random.default_rng(12)
    k, L, B, n = 4, 4, 2, 96
    tabs = _tables(rng, k, L)
    tree = vocab.pack_centers([torch.from_numpy(t) for t in tabs], k)
    q = _signs(rng, (B, n, 256))
    q[0, ::7] = 0.0
    q[1, 3::5] = 0.0
    bits, valid = _packed_query(q.reshape(-1, 256))
    flat = vocab._descend_packed_plain(bits, valid, tree, k, L).reshape(B, n)
    for b in range(B):
        wj = np.asarray(jvocab._descend([jnp.asarray(t) for t in tabs], jnp.asarray(q[b]), k, L))
        np.testing.assert_array_equal(flat[b].numpy(), wj)
        lane = vocab._descend_packed_plain(*_packed_query(q[b]), tree, k, L)
        assert torch.equal(flat[b], lane)


def test_vocabulary_packs_once():
    rng = np.random.default_rng(13)
    k = 3
    voc = vocab.Vocabulary(k=k, levels=2, centers=[torch.from_numpy(t) for t in
                                                   _tables(rng, k, 2)], idf=torch.ones(9))
    tree = voc.packed()
    assert voc.packed() is tree
    moved = voc.to("cpu")
    assert moved.packed().words is tree.words  # carried, not packed again
    q = torch.from_numpy(_signs(rng, (5, 256)))
    assert torch.equal(vocab.transform_words(voc, q), vocab.transform_words(moved, q))


@pytest.mark.parametrize("max_dense", [8192, 16])
def test_descend_ties_first_max(monkeypatch, max_dense):
    """Duplicate sibling rows and all-zero descriptors: exact ties at every
    level.  The port has one route; it meets the JAX package's dense route
    (all levels <= 8192 rows) and its deep gather route (the JAX
    threshold lowered to 16 rows) in turn."""
    monkeypatch.setattr(jvocab, "_DESCEND_MASKED_ARGMAX_MAX_NODES", max_dense)
    rng = np.random.default_rng(7)
    k, L = 4, 3
    tabs = []
    for t in _tables(rng, k, L):
        t = t.reshape(-1, k, 256)
        t[:, 2] = t[:, 1]
        t[:, 3] = t[:, 0]
        tabs.append(t.reshape(-1, 256))
    q = _signs(rng, (128, 256))
    q[::5] = 0.0
    wj = np.asarray(jvocab._descend([jnp.asarray(t) for t in tabs], jnp.asarray(q), k, L))
    wt = vocab._descend([torch.from_numpy(t) for t in tabs], torch.from_numpy(q), k, L)
    np.testing.assert_array_equal(wt.numpy(), wj)
    tree = vocab.pack_centers([torch.from_numpy(t) for t in tabs], k)
    wp = vocab._descend_packed_plain(*_packed_query(q), tree, k, L)
    np.testing.assert_array_equal(wp.numpy(), wj)
    for m in range(L):  # no level took a duplicate (sibling 2 or 3)
        assert set(np.unique(wj // k ** m % k)) <= {0, 1}


def _corpus(rng, n=600, n_clusters=12):
    """Sign descriptors around a few cluster centers (10 % bit noise)."""
    cent = _signs(rng, (n_clusters, 256))
    X = cent[rng.integers(0, n_clusters, n)]
    flip = rng.random(X.shape) < 0.1
    return np.where(flip, -X, X).astype(np.float32), rng.integers(0, 20, n)


def test_train_batched_equal_from_same_init():
    rng = np.random.default_rng(1)
    X, docs = _corpus(rng)
    k, L, iters = 3, 3, 3
    # The JAX trainer's loop, recording its initial centers per level.
    Xj = jnp.asarray(X)
    node = jnp.zeros((X.shape[0],), jnp.int32)
    key = jax.random.PRNGKey(0)
    inits, centers_j = [], []
    for level in range(L):
        G = k ** (level + 1)
        key, k1 = jax.random.split(key)
        C = jvocab._init_level(k1, Xj, node, k, G)
        inits.append(np.array(C))
        for _ in range(iters):
            C = jvocab._update_level(Xj, jvocab._assign_level(Xj, node, C, k), C, G)
        node = jvocab._assign_level(Xj, node, C, k)
        centers_j.append(np.asarray(C))
    voc_j = jvocab.Vocabulary(k=k, levels=L, centers=[jnp.asarray(c) for c in centers_j],
                              idf=np.ones((k**L,), np.float32))
    jvocab._idf_of(voc_j, X, docs)

    Xt = torch.from_numpy(X)
    centers_t = vocab._train_levels(Xt, k, L, iters,
                                    lambda level, node, G: torch.from_numpy(inits[level]))
    for ct, cj in zip(centers_t, centers_j):
        np.testing.assert_array_equal(ct.numpy(), cj)
    voc_t = vocab.Vocabulary(k=k, levels=L, centers=centers_t, idf=torch.ones(k**L))
    vocab._idf_of(voc_t, Xt, docs)
    np.testing.assert_allclose(voc_t.idf.numpy(), voc_j.idf, atol=1e-6)


def test_train_batched_seeded_and_clusters():
    """The port's own draws: one seed, one vocabulary; each cluster of the
    corpus lands mostly in one word."""
    rng = np.random.default_rng(2)
    X, docs = _corpus(rng)
    a = vocab.train_batched(X, k=3, levels=3, iters=4, seed=5, doc_ids=docs, device="cpu")
    b = vocab.train_batched(X, k=3, levels=3, iters=4, seed=5, doc_ids=docs, device="cpu")
    for ca, cb in zip(a.centers, b.centers):
        assert torch.equal(ca, cb)
        assert ca.dtype == torch.int8 and set(torch.unique(ca).tolist()) <= {-1, 1}
    assert torch.equal(a.idf, b.idf)
    words = vocab.transform_words(a, torch.from_numpy(X)).numpy()
    assert words.max() < a.n_words
    assert len(np.unique(words)) >= 6


@pytest.fixture(scope="module")
def small_vocab():
    rng = np.random.default_rng(3)
    X, docs = _corpus(rng, n=400)
    return jvocab.train(X, k=4, levels=3, doc_ids=docs), rng


def test_sparse_bow_and_scores_match_reference(small_vocab):
    voc_j, rng = small_vocab
    voc_t = convert.vocab_from_numpy(voc_j, "cpu")
    n_words = voc_j.n_words
    frames = []
    for f in range(4):
        q = _signs(rng, (96, 256))
        valid = rng.random(96) > 0.2
        q[~valid] = 0.0
        wj = jvocab.transform_words(voc_j, jnp.asarray(q))
        wt = vocab.transform_words(voc_t, torch.from_numpy(q))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        uwj, uvj = jvocab.bow_sparse(wj, jnp.asarray(valid), jnp.asarray(voc_j.idf), n_words)
        uwt, uvt = vocab.bow_sparse(wt, torch.from_numpy(valid), voc_t.idf, n_words)
        np.testing.assert_array_equal(uwt.numpy(), np.asarray(uwj))
        np.testing.assert_allclose(uvt.numpy(), np.asarray(uvj), atol=1e-6)
        frames.append(((uwj, uvj), (uwt, uvt)))
    bj = [jvocab.bin_of_sparse(*fj, 64) for fj, _ in frames]
    bt = [vocab.bin_of_sparse(*ft, 64) for _, ft in frames]
    for a, b in zip(bt, bj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    db_j = jnp.stack(bj[1:]).astype(jnp.bfloat16)
    db_t = torch.stack(bt[1:]).to(torch.bfloat16)
    sj = np.asarray(jvocab.score_db_binned(bj[0], db_j))
    st = vocab.score_db_binned(bt[0], db_t).numpy()
    np.testing.assert_allclose(st, sj, rtol=8e-3, atol=1e-6)
    (uwj, uvj), (uwt, uvt) = frames[0]
    for (cj, ct) in frames[1:]:
        np.testing.assert_allclose(float(vocab.score_pair_min(uwt, uvt, *ct)),
                                   float(jvocab.score_pair_min(uwj, uvj, *cj)), atol=1e-6)
    cw_j = jnp.stack([f[0][0] for f in frames[1:]])
    cv_j = jnp.stack([f[0][1] for f in frames[1:]])
    cw_t = torch.stack([f[1][0] for f in frames[1:]])
    cv_t = torch.stack([f[1][1] for f in frames[1:]])
    np.testing.assert_allclose(vocab.rescore_min(uwt, uvt, cw_t, cv_t).numpy(),
                               np.asarray(jvocab.rescore_min(uwj, uvj, cw_j, cv_j)), atol=1e-6)
    # an all-invalid frame has no mass
    uw0, uv0 = vocab.bow_sparse(wt, torch.zeros(96, dtype=torch.bool), voc_t.idf, n_words)
    assert not uw0.any() and not uv0.any()


def test_vocab_from_numpy_round_trip(small_vocab, tmp_path):
    voc_j, _ = small_vocab
    path_j = tmp_path / "jax.npz"
    voc_j.save(str(path_j))
    from_file = convert.vocab_from_numpy(path_j, "cpu")
    from_obj = convert.vocab_from_numpy(voc_j, "cpu")
    for v in (from_file, from_obj):
        assert (v.k, v.levels, v.n_words) == (voc_j.k, voc_j.levels, voc_j.n_words)
        for ct, cj in zip(v.centers, voc_j.centers):
            assert ct.dtype == torch.int8
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(v.idf.numpy(), voc_j.idf)
    path_t = tmp_path / "port.npz"
    from_file.save(str(path_t))
    back = jvocab.Vocabulary.load(str(path_t))
    assert (back.k, back.levels) == (voc_j.k, voc_j.levels)
    for cb, cj in zip(back.centers, voc_j.centers):
        np.testing.assert_array_equal(np.asarray(cb), np.asarray(cj))
    np.testing.assert_array_equal(back.idf, voc_j.idf)


def _equal_vocabularies(vt, vj) -> None:
    assert (vt.k, vt.levels) == (vj.k, vj.levels)
    for ct, cj in zip(vt.centers, vj.centers, strict=True):
        assert ct.dtype == torch.int8
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert vt.idf.dtype == torch.float32
    np.testing.assert_array_equal(vt.idf.numpy(), vj.idf)


@pytest.mark.parametrize("k,levels,n", [(4, 3, 400), (3, 3, 24), (8, 3, 300)])
def test_train_bitwise_equal_to_reference(k, levels, n):
    """The host-recursive trainer: numpy's draws, first-max assignments and
    majority votes give the JAX trainer's centres and IDF bit for bit.  At
    these sizes some level-2 nodes hold fewer descriptors than k (random
    sign children) and some none (all children random)."""
    rng = np.random.default_rng(40 + k)
    X, docs = _corpus(rng, n=n)
    vt = vocab.train(X, k=k, levels=levels, doc_ids=docs, device="cpu")
    vj = jvocab.train(X, k=k, levels=levels, doc_ids=docs)
    _equal_vocabularies(vt, vj)
    # a node of the recursion's last level holds fewer descriptors than k
    words = vocab.transform_words(vt, torch.from_numpy(X)).numpy()
    parents = np.bincount(words // k, minlength=k ** (levels - 1))
    assert (parents < k).any(), parents
    # no doc ids: uniform weights, as the reference
    flat = vocab.train(X, k=k, levels=levels, device="cpu")
    np.testing.assert_array_equal(flat.idf.numpy(), np.ones(k ** levels, np.float32))


def test_kmeans_signs_matches_reference():
    rng = np.random.default_rng(50)
    X, _ = _corpus(rng, n=90)
    for k, seed, n in ((5, 3, 90), (9, 1, 4), (4, 2, 0)):
        np.testing.assert_array_equal(vocab._kmeans_signs(X[:n], k, seed=seed),
                                      jvocab._kmeans_signs(X[:n], k, seed=seed))


def test_build_vocab_picks_the_trainer_by_size():
    rng = np.random.default_rng(51)
    X, docs = _corpus(rng, n=120)
    small = vocab.build_vocab(X, 4, 2, doc_ids=docs, device="cpu")
    _equal_vocabularies(small, vocab.train(X, k=4, levels=2, doc_ids=docs, device="cpu"))
    big = vocab.build_vocab(X, 17, 3, doc_ids=docs, device="cpu")  # 4,913 words
    _equal_vocabularies(big, vocab.train_batched(X, k=17, levels=3, doc_ids=docs, device="cpu"))


def test_dense_bow_oracles_match_reference(small_vocab):
    voc_j, rng = small_vocab
    voc_t = convert.vocab_from_numpy(voc_j, "cpu")
    n_words = voc_j.n_words
    rows_j, rows_t, sparse_j, sparse_t = [], [], [], []
    for f in range(4):
        words = rng.integers(0, n_words, 80)
        words[:10] = words[10:20]  # duplicates merge
        valid = rng.random(80) > 0.2
        wj, vj = jnp.asarray(words, jnp.int32), jnp.asarray(valid)
        wt, vt = torch.from_numpy(words), torch.from_numpy(valid)
        rows_j.append(jvocab.bow_row(wj, vj, jnp.asarray(voc_j.idf), n_words))
        rows_t.append(vocab.bow_row(wt, vt, voc_t.idf, n_words))
        np.testing.assert_allclose(rows_t[-1].numpy(), np.asarray(rows_j[-1]), atol=1e-7)
        sparse_j.append(jvocab.bow_sparse(wj, vj, jnp.asarray(voc_j.idf), n_words))
        sparse_t.append(vocab.bow_sparse(wt, vt, voc_t.idf, n_words))
    np.testing.assert_allclose(vocab.score_l1(rows_t[0], torch.stack(rows_t)).numpy(),
                               np.asarray(jvocab.score_l1(rows_j[0], jnp.stack(rows_j))),
                               atol=1e-6)
    qj = jvocab.dense_of_sparse(*sparse_j[0], n_words)
    qt = vocab.dense_of_sparse(*sparse_t[0], n_words)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-7)
    dbw_j = jnp.stack([s[0] for s in sparse_j])
    dbv_j = jnp.stack([s[1] for s in sparse_j])
    dbw_t = torch.stack([s[0] for s in sparse_t])
    dbv_t = torch.stack([s[1] for s in sparse_t])
    got = vocab.score_db_sparse(qt, dbw_t, dbv_t).numpy()
    np.testing.assert_allclose(got, np.asarray(jvocab.score_db_sparse(qj, dbw_j, dbv_j)),
                               atol=1e-6)
    # the min-intersection identity: the sparse scores are the dense L1 scores
    np.testing.assert_allclose(got, vocab.score_l1(rows_t[0], torch.stack(rows_t)).numpy(),
                               atol=1e-5)
    for (wj, vj), (wt, vt) in zip(sparse_j, sparse_t):
        np.testing.assert_allclose(float(vocab.score_pair_sparse(qt, wt, vt)),
                                   float(jvocab.score_pair_sparse(qj, wj, vj)), atol=1e-6)


def test_trained_vocabulary_npz_crosses_both_ways(tmp_path):
    """A vocabulary the port trains loads in the JAX package with equal
    centres and IDF, and the reverse."""
    rng = np.random.default_rng(52)
    X, docs = _corpus(rng, n=200)
    vt = vocab.train(X, k=4, levels=3, doc_ids=docs, device="cpu")
    vt.save(str(tmp_path / "port.npz"))
    _equal_vocabularies(vt, jvocab.Vocabulary.load(str(tmp_path / "port.npz")))
    vj = jvocab.train(X, k=3, levels=2, doc_ids=docs)
    vj.save(str(tmp_path / "jax.npz"))
    _equal_vocabularies(vocab.Vocabulary.load(str(tmp_path / "jax.npz"), device="cpu"), vj)
