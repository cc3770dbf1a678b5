import os

from tsta_tpu.utils import checkpoint, profiling


def test_phase_timers():
    ph = profiling.Phase()
    with ph("a"):
        pass
    with ph("a"):
        pass
    rep = ph.report()
    assert rep[0]["phase"] == "a" and rep[0]["calls"] == 2


def test_gcups():
    assert profiling.gcups(2e9, 2.0) == 1.0


def test_sharded_results_resume(tmp_path):
    p = str(tmp_path / "res.jsonl")
    st = checkpoint.ShardedResults(p)
    st.record({"name": "x", "score": 1})
    st.record({"name": "y", "score": 2})
    st2 = checkpoint.ShardedResults(p)  # reload
    assert st2.done("x") and st2.get("y")["score"] == 2
    assert len(st2.results()) == 2


def test_graph_snapshot_roundtrip(tmp_path):
    from tsta_tpu.models.poa_graph import PoaGraph, load_graph, save_graph
    g = PoaGraph.from_sequence(b"ACGT", 2)
    p = str(tmp_path / "g.npz")
    save_graph(p, g, extra={"round": 1})
    g2, extra = load_graph(p)
    assert extra["round"] == 1
    assert g2.bases == g.bases and g2.preds == g.preds
    assert checkpoint.seqs_digest([b"A"]) != checkpoint.seqs_digest([b"C"])


def test_graph_array_storage_growth(tmp_path):
    """The array-backed PoaGraph grows node / pred-slot / variant-ring
    capacity transparently, keeps rows beyond _n all-zero (the C merge
    relies on it), and snapshots round-trip with variants + weights."""
    import numpy as np

    from tsta_tpu.models.poa_graph import PoaGraph, load_graph, save_graph

    g = PoaGraph(n_seq=3, cap=1)
    hub = g.add_node(ord("A"), 0)
    # force pred-slot growth well past the initial 4
    spokes = [g.add_node(ord("C"), 0) for _ in range(9)]
    for s in spokes:
        g.add_edge(s, hub)
    assert g.preds[hub] == spokes
    assert g.weights[hub] == [1] * 9
    g.add_edge(spokes[3], hub)        # weight bump, not a new slot
    assert g.weights[hub][3] == 2 and len(g.preds[hub]) == 9
    # add_node with an explicit long preds list
    v = g.add_node(ord("G"), 1, preds=spokes[:7])
    assert g.preds[v] == spokes[:7]
    # variant-ring growth past the initial 4 slots (exotic alphabet)
    ring_head = spokes[0]
    for k, ch in enumerate(b"GTNXY"):
        w = g.add_node(ch, 2)
        for r in [ring_head] + g.variants[ring_head]:
            g._vars[r, g._nvar[r]] = w
            g._nvar[r] += 1
            if g._nvar[r] == g._vars.shape[1]:
                g._grow(vmax=g._nvar[r] + 1)
        g._vars[w, :g._nvar[ring_head]] = \
            [ring_head] + g.variants[ring_head][:-1]
        g._nvar[w] = g._nvar[ring_head]
    assert len(g.variants[ring_head]) == 5
    # rows past _n stay all-zero after growth
    n = len(g)
    assert not g._ndeg[n:].any() and not g._nvar[n:].any()
    assert not g._passing[n:].any()
    g.toposort()
    p = str(tmp_path / "g.npz")
    save_graph(p, g, extra={})
    g2, _ = load_graph(p)
    assert g2.bases == g.bases and g2.preds == g.preds
    assert g2.weights == g.weights and g2.variants == g.variants
    assert [r.tolist() for r in g2.passing] == \
        [r.tolist() for r in g.passing]


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    import jax

    from tsta_tpu.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            cache.CHECKOUT, ".tsta_cache", "jax")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    import jax

    from tsta_tpu.utils import cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before
