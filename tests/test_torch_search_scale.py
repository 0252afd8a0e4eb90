"""The port's schedule search at P = 64 against the JAX package's, on the
CPU: tests/test_sched_search.py:281's Allreduce search on the 4x
oversubscribed FatTree(k = 8, 64 hosts), every field of the SearchResult
equal (the wall clock aside) and the searched schedule no slower than the
best builder. The reference's test also holds the search to a 30 s wall
clock; this one does not (a loaded CPU misses any budget): the card's
smoke run holds the port's searches to it. In a file of its own so that
the other search tests run beside it.
"""
from repro.core import sched_search as ref_search
from repro.core import topology as ref_topo
from repro_torch.core import sched_search, topology
from test_torch_allreduce import assert_same


def test_search_p64_matches_reference():
    got = sched_search.search("allreduce", 64, 16 << 20, validate_packet=False,
                              topology=topology.FatTree(k=8, n_hosts=64, oversubscription=4.0),
                              device="cpu")
    want = ref_search.search("allreduce", 64, 16 << 20, validate_packet=False,
                             topology=ref_topo.FatTree(k=8, n_hosts=64, oversubscription=4.0))
    assert_same(got, want, skip=("wall_s",))
    assert got.searched_vs_best_builder <= 1.0
