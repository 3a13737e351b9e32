"""TorchNode's document and index API against TpuNode's, at the library
level.

The same calls go to both nodes, one after another; each must return the
same response (with `took` and an index's uuid and creation date removed)
or raise an error of the same type, status and message: `index_doc` with
`op_type`, `if_seq_no` / `if_primary_term` and `version` / `version_type`
(and an index created on first write), `get_doc` (realtime, `refresh`,
`version`), `delete_doc`, `update_doc` with a partial `doc`,
`doc_as_upsert`, `upsert`, `detect_noop` and `_source`, `bulk` with an
update action, `get_mapping`, `get_settings`, `resolve_indices`,
`cluster_health` and `delete_index`. Then the parts once outside the port
(scripted updates, ingest pipelines, wildcard expressions) answer as the
reference's do, and `delete_index` releases the index's stacked serving
slabs from the device.
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")

from opensearch_tpu.common.errors import OpenSearchTpuException as JaxError
from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.cluster import shard_mesh
from opensearch_tpu_torch.common.errors import OpenSearchTpuException
from opensearch_tpu_torch.node import TorchNode

from test_torch_rest import _assert_same, _strip

DIM = 4
MAPPING = {"properties": {"v": {"type": "knn_vector", "dimension": DIM},
                          "age": {"type": "integer"},
                          "tag": {"type": "keyword"},
                          "user": {"properties": {"name": {"type": "keyword"},
                                                  "rank": {"type": "integer"}}}}}


def _doc(i: int) -> dict:
    return {"v": [float(i), 1.0, 0.5, -1.0], "age": i, "tag": f"t{i % 3}",
            "user": {"name": f"u{i}", "rank": i * 2}}


# (label, method, args, kwargs), run in order on both nodes
CALLS = [
    ("create", "create_index", ("d",), {"body": {
        "settings": {"number_of_shards": 3}, "mappings": MAPPING}}),
    ("create_one_shard", "create_index", ("e",), {"body": {
        "settings": {"index.number_of_shards": 1,
                     "index.number_of_replicas": 0},
        "mappings": MAPPING}}),
    ("index_1", "index_doc", ("d", "1", _doc(1)), {}),
    ("index_1_again", "index_doc", ("d", "1", _doc(2)), {}),
    ("index_routed", "index_doc", ("d", "r1", _doc(3)), {"routing": "k7"}),
    ("index_create_conflict", "index_doc", ("d", "1", _doc(4)),
     {"op_type": "create"}),
    ("index_create_new", "index_doc", ("d", "2", _doc(4)),
     {"op_type": "create", "refresh": True}),
    ("index_cas_ok", "index_doc", ("d", "1", _doc(5)),
     {"if_seq_no": 1, "if_primary_term": 1}),
    ("index_cas_stale", "index_doc", ("d", "1", _doc(5)),
     {"if_seq_no": 1, "if_primary_term": 1}),
    ("index_term_without_seq", "index_doc", ("d", "1", _doc(5)),
     {"if_primary_term": 1}),
    ("index_wrong_term", "index_doc", ("d", "1", _doc(5)),
     {"if_seq_no": 3, "if_primary_term": 2}),
    ("index_external", "index_doc", ("d", "x1", _doc(6)),
     {"version": 10, "version_type": "external"}),
    ("index_external_stale", "index_doc", ("d", "x1", _doc(6)),
     {"version": 10, "version_type": "external"}),
    ("index_external_gte", "index_doc", ("d", "x1", _doc(7)),
     {"version": 10, "version_type": "external_gte"}),
    ("index_internal_version", "index_doc", ("d", "x1", _doc(7)),
     {"version": 3}),
    ("create_external", "index_doc", ("d", "x2", _doc(7)),
     {"op_type": "create", "version": 3, "version_type": "external"}),
    ("index_long_id", "index_doc", ("d", "i" * 600, _doc(1)), {}),
    ("index_autocreates", "index_doc", ("auto", "1", {"age": 3}), {}),
    ("get_1", "get_doc", ("d", "1"), {}),
    ("get_1_not_realtime", "get_doc", ("d", "1"), {"realtime": False}),
    ("get_1_refresh", "get_doc", ("d", "1"), {"refresh": True}),
    ("get_1_version_ok", "get_doc", ("d", "1"), {"version": 3}),
    ("get_1_version_bad", "get_doc", ("d", "1"), {"version": 1}),
    ("get_routed", "get_doc", ("d", "r1"), {"routing": "k7"}),
    ("get_missing", "get_doc", ("d", "nope"), {}),
    ("get_missing_index", "get_doc", ("zz", "1"), {}),
    ("delete_2", "delete_doc", ("d", "2"), {}),
    ("delete_2_again", "delete_doc", ("d", "2"), {}),
    ("delete_cas_stale", "delete_doc", ("d", "1"), {"if_seq_no": 0}),
    ("delete_external", "delete_doc", ("d", "x1"),
     {"version": 20, "version_type": "external"}),
    ("update_partial", "update_doc", ("d", "1", {"doc": {"age": 50}}), {}),
    ("update_nested_partial", "update_doc",
     ("d", "1", {"doc": {"user": {"rank": 9}}}), {}),
    ("update_noop", "update_doc", ("d", "1", {"doc": {"age": 50}}), {}),
    ("update_no_detect", "update_doc",
     ("d", "1", {"doc": {"age": 50}, "detect_noop": False}), {}),
    ("update_source", "update_doc",
     ("d", "1", {"doc": {"tag": "z"}, "_source": ["tag", "user.*"]}), {}),
    ("update_missing", "update_doc", ("d", "u1", {"doc": {"age": 1}}), {}),
    ("update_doc_as_upsert", "update_doc",
     ("d", "u1", {"doc": _doc(8), "doc_as_upsert": True}), {}),
    ("update_upsert", "update_doc",
     ("d", "u2", {"doc": {"age": 1}, "upsert": _doc(9)}), {"refresh": True}),
    ("update_upsert_alone", "update_doc", ("d", "u3", {"upsert": _doc(10)}),
     {}),
    ("update_upsert_existing", "update_doc", ("d", "u3", {"upsert": _doc(11)}),
     {}),
    ("update_cas_ok", "update_doc", ("d", "u2", {"doc": {"age": 2}}),
     {"if_seq_no": 13}),
    ("update_cas_missing", "update_doc", ("d", "u9", {"doc": {"age": 2}}),
     {"if_seq_no": 1}),
    ("update_unknown_key", "update_doc", ("d", "u2", {"docs": {}}), {}),
    ("update_nothing", "update_doc", ("d", "u2", {}), {}),
    ("update_require_alias", "update_doc", ("d", "u2", {"doc": {}}),
     {"require_alias": True}),
    ("update_autocreates", "update_doc",
     ("auto2", "1", {"doc": {"a": 1}, "doc_as_upsert": True}), {}),
    ("bulk", "bulk", ([
        ("index", {"_index": "d", "_id": "b1"}, _doc(12)),
        ("create", {"_index": "d", "_id": "b1"}, _doc(12)),
        ("index", {"_index": "d", "_id": "b2", "op_type": "create"}, _doc(13)),
        ("update", {"_index": "d", "_id": "b1"}, {"doc": {"age": 77}}),
        ("update", {"_index": "d", "_id": "b1"}, {"doc": {"age": 77}}),
        ("update", {"_index": "d", "_id": "b3"},
         {"doc": {"age": 1}, "doc_as_upsert": True}),
        ("update", {"_index": "d", "_id": "b4", "_source": True},
         {"doc": {"age": 1}, "upsert": _doc(14)}),
        ("update", {"_index": "d", "_id": "nope", "if_seq_no": 3},
         {"doc": {"age": 1}}),
        ("update", {"_index": "d", "_id": "nope2"}, {"doc": {"age": 1}}),
        ("update", {"_index": "d", "_id": "b1", "if_seq_no": 0},
         {"doc": {"age": 3}}),
        ("delete", {"_index": "d", "_id": "b2"}, None),
        ("delete", {"_index": "d", "_id": "b2"}, None),
        ("index", {"_index": "d", "_id": ""}, _doc(1)),
        ("index", {"_index": "d", "_id": 42, "routing": 5}, _doc(1)),
        ("index", {"_index": "d", "_id": "b9", "if_seq_no": 99,
                   "if_primary_term": 1}, _doc(1)),
        ("index", {"_index": "bulkauto", "_id": "1"}, {"age": 1}),
    ],), {"refresh": True}),
    ("get_b1", "get_doc", ("d", "b1"), {}),
    ("get_b4", "get_doc", ("d", "b4"), {}),
    ("get_42", "get_doc", ("d", "42"), {"routing": "5"}),
    ("refresh", "refresh", ("d",), {}),
    ("refresh_all", "refresh", ("_all",), {}),
    ("mapping", "get_mapping", ("d",), {}),
    ("mapping_all", "get_mapping", ("_all",), {}),
    ("mapping_missing", "get_mapping", ("zz",), {}),
    ("mapping_ignore", "get_mapping", ("d,zz",), {"ignore_unavailable": True}),
    ("settings", "get_settings", ("d",), {}),
    ("settings_flat", "get_settings", ("e",), {"flat": True}),
    ("settings_defaults", "get_settings", ("e",),
     {"include_defaults": True, "name": "index.max_*"}),
    ("resolve", "resolve_indices", ("d,e",), {}),
    ("resolve_all", "resolve_indices", ("_all",), {}),
    ("resolve_missing", "resolve_indices", ("d,zz",), {}),
    ("resolve_ignore", "resolve_indices", ("zz",),
     {"ignore_unavailable": True}),
    ("resolve_no_indices", "resolve_indices", ("zz",),
     {"ignore_unavailable": True, "allow_no_indices": False}),
    ("health", "cluster_health", (), {}),
    ("health_index_green", "cluster_health", ("e",), {"level": "shards"}),
    ("health_indices", "cluster_health", (), {"level": "indices"}),
    ("delete_index", "delete_index", ("e",), {}),
    ("delete_index_missing", "delete_index", ("e",), {}),
    ("delete_index_ignored", "delete_index", ("e,d",),
     {"ignore_unavailable": True}),
    ("delete_index_none", "delete_index", ("zz",),
     {"ignore_unavailable": True, "allow_no_indices": False}),
    ("health_after", "cluster_health", (), {"level": "indices"}),
]


def _outcome(node, method, args, kwargs, errors):
    try:
        return ("ok", getattr(node, method)(*args, **kwargs))
    except errors as e:
        return ("error", type(e).__name__, e.status, str(e))


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    out = {}
    try:
        for label, method, args, kwargs in CALLS:
            out[label] = (_outcome(ref, method, args, kwargs, JaxError),
                          _outcome(port, method, args, kwargs,
                                   OpenSearchTpuException))
    finally:
        ref.close()
        port.close()
    return out


@pytest.mark.parametrize("label", [c[0] for c in CALLS])
def test_call_matches_reference(transcripts, label):
    want, got = transcripts[label]
    assert got[0] == want[0], (got, want)
    if want[0] == "error":
        assert got[1:] == want[1:]
    else:
        _assert_same(_strip(want[1]), _strip(got[1]))


def test_the_sequence_exercises_both_outcomes(transcripts):
    kinds = [want[0] for want, _got in transcripts.values()]
    assert kinds.count("ok") > 40 and kinds.count("error") > 15


@pytest.fixture()
def node(tmp_path):
    n = TorchNode(tmp_path, device="cpu")
    n.create_index("d", {"mappings": MAPPING})
    n.bulk([("index", {"_index": "d", "_id": str(i)}, _doc(i))
            for i in range(20)], refresh=True)
    yield n
    n.close()


@pytest.mark.parametrize("call", [
    ("update_doc", ("d", "1", {"script": {"source": "ctx._source.age++"}}),
     "scripted updates"),
    ("index_doc", ("d", "9", _doc(9)), "ingest pipelines"),
    ("bulk", ([("index", {"_index": "d", "_id": "9",
                          "pipeline": "p"}, _doc(9))],), "ingest pipelines"),
    ("resolve_indices", ("d*",), "wildcard index expressions"),
    ("delete_index", ("d*",), "wildcard index expressions"),
    ("search", ("d?", {}), "wildcard index expressions"),
], ids=["script", "pipeline", "bulk_pipeline", "wildcard_resolve",
        "wildcard_delete", "wildcard_search"])
def test_unported_parts_raise(node, call, tmp_path):
    """The parts that once raised "not yet ported" are served now: a
    scripted update, a write naming a missing ingest pipeline (an error of
    the API, per item in a bulk) and wildcard index expressions answer as
    the reference's do."""
    method, args, what = call
    kwargs = {"pipeline": "p"} if method == "index_doc" else {}
    ref = TpuNode(tmp_path / "ref")
    try:
        ref.create_index("d", {"mappings": MAPPING})
        ref.bulk([("index", {"_index": "d", "_id": str(i)}, _doc(i))
                  for i in range(20)], refresh=True)
        want = _observe(lambda: getattr(ref, method)(*args, **kwargs))
        want_doc = ref.get_doc("d", "1") if "d" in ref.indices else None
    finally:
        ref.close()
    got = _observe(lambda: getattr(node, method)(*args, **kwargs))
    if what == "scripted updates":
        for key in ("result", "_version", "_seq_no"):
            assert got[1][key] == want[1][key], key
        assert node.get_doc("d", "1")["_source"] == want_doc["_source"]
        assert want_doc["_source"]["age"] == 2
        return
    _assert_same(_strip(want), _strip(got))
    if what == "ingest pipelines":
        errors = (got[:2] == ("error", "IllegalArgumentException")
                  or got[1]["items"][0]["index"]["status"] == 400)
        assert errors, got
    if method == "delete_index":
        assert "d" not in node.indices


def _observe(fn):
    try:
        return ("ok", fn())
    except (OpenSearchTpuException, JaxError) as e:
        return ("error", type(e).__name__, e.status, str(e))


def test_delete_index_releases_the_serving_slabs(node):
    body = {"query": {"knn": {"v": {"vector": [3.0, 1.0, 0.5, -1.0],
                                    "k": 3}}}}
    assert [h["_id"] for h in node.search("d", body)["hits"]["hits"]][0] == "3"
    registry = shard_mesh.default_registry
    assert any(key[0] == "d" for key in registry._bundles)
    node.delete_index("d")
    assert not any(key[0] == "d" for key in registry._bundles)
    assert "d" not in node.indices
    assert not (node.data_path / "indices" / "d").exists()


def test_node_name(tmp_path):
    assert TorchNode(tmp_path, device="cpu").node_name == "node-0"
    assert TorchNode(tmp_path, device="cpu", node_name="n7").node_name == "n7"


def test_bulk_update_refreshes_into_search(node):
    """A bulk update is searchable after its refresh, with its version."""
    resp = node.bulk([("update", {"_index": "d", "_id": "4"},
                       {"doc": {"v": [100.0, 1.0, 0.5, -1.0]}})],
                     refresh=True)
    assert resp["items"][0]["update"]["result"] == "updated"
    hits = node.search("d", {"query": {"knn": {"v": {
        "vector": [100.0, 1.0, 0.5, -1.0], "k": 1}}}, "size": 1,
        "version": True})["hits"]["hits"]
    assert (hits[0]["_id"], hits[0]["_version"]) == ("4", 2)
