"""The dense scan (K3) over a REAL port index: for every partition and
every plan path of a query batch, ``ops.dominance_scan`` of the query
path against the partition's ``emb ⊕ emb_multi`` and ``emb0`` keeps
exactly the rows the engine's loop probe kept, in the single form and in
the batch form."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GnnPeConfig, GnnPeEngine  # noqa: E402
from repro_torch.graphs import erdos_renyi, random_connected_query  # noqa: E402
from repro_torch.kernels.dominance_scan import ops  # noqa: E402


@pytest.mark.parametrize("n_partitions,n_multi", [(1, 1), (3, 2)])
def test_dense_scan_keeps_the_loop_probes_rows(n_partitions, n_multi):
    g = erdos_renyi(200, avg_degree=3.5, n_labels=5, seed=6)
    cfg = GnnPeConfig(n_partitions=n_partitions, encoder="monotone", n_multi=n_multi)
    eng = GnnPeEngine(cfg, device="cpu").build(g)
    queries = [random_connected_query(g, 5, seed=42 + s) for s in range(3)]
    q_embs = eng._query_node_embeddings_many(queries)
    cat, spans, _ = q_embs
    plans = [eng._deg_plan_cached(q) for q in queries]
    requests = list(dict.fromkeys((qi, p) for qi, pl in enumerate(plans) for p in pl.paths))
    memo: dict = {}
    eng._probe_batch(requests, q_embs, memo)
    kept = 0
    for mi, model in enumerate(eng.models):
        idx = model.index
        o, o0, om = cat[mi]
        e_cat = torch.cat([idx.emb] + [idx.emb_multi[i] for i in range(n_multi)], dim=1)
        q_rows, q0_rows = [], []
        for qi, p in requests:
            pv = torch.as_tensor(spans[qi] + np.asarray(p))
            q_rows.append(torch.cat([o[pv].reshape(-1)] + [om[i][pv].reshape(-1) for i in range(n_multi)]))
            q0_rows.append(o0[pv].reshape(-1))
        batch = ops.dominance_scan(torch.stack(q_rows), torch.stack(q0_rows), e_cat, idx.emb0)
        assert batch.shape == (len(requests), idx.n_paths)
        for k, (qi, p) in enumerate(requests):
            want = np.sort(memo[(mi, qi, p)].numpy())
            single = ops.dominance_scan(q_rows[k], q0_rows[k], e_cat, idx.emb0)
            np.testing.assert_array_equal(torch.nonzero(single)[:, 0].numpy(), want)
            np.testing.assert_array_equal(torch.nonzero(batch[k])[:, 0].numpy(), want)
            kept += want.size
    assert kept > 0
