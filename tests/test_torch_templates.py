"""Index templates on the port against the reference.

Composable templates built from component templates, their priority, the
legacy `/_template` ones (order, flat settings, alias routing) and the
composable ones shadowing them, each scenario on a TpuNode and a
TorchNode(device="cpu") with the observations equal as JSON (errors by
class, status and message), `took` and index uuids and creation dates left
out. An index a write auto-creates takes its template; `create_index`'s
body layers over the template; the merged settings and mappings go into
the index registry, so a restart reopens the index with them even after
the template is gone. Then the port alone: a template's
`index.default_pipeline` runs on the very write that auto-creates the
index (the reference reads no template there and indexes the first
document raw: a difference stated in ROADMAP.md).
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.node import TorchNode

from test_torch_scroll_pit import Pair, observe

DIM = 4
COMPONENT = {"template": {
    "settings": {"number_of_shards": 2, "number_of_replicas": 0},
    "mappings": {"properties": {
        "v": {"type": "knn_vector", "dimension": DIM,
              "similarity": "l2_norm"},
        "tag": {"type": "keyword"}}}}}


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def test_composable_template_from_components(pair):
    def scenario(node):
        out = [node.put_component_template("vecs", COMPONENT),
               node.put_component_template("views", {"template": {
                   "mappings": {"properties": {"views": {"type": "long"}}},
                   "aliases": {"all-vec": {}}}}),
               node.put_index_template("vec", {
                   "index_patterns": ["vec-*"], "priority": 10,
                   "composed_of": ["vecs", "views"],
                   "template": {"settings": {"index": {
                       "refresh_interval": "5s"}}}}),
               node.put_index_template("low", {
                   "index_patterns": ["vec-*"], "priority": 1,
                   "template": {"settings": {"number_of_shards": 5}}}),
               node.get_index_template(), node.get_index_template("v*"),
               node.get_component_template(),
               node.get_component_template("vecs"),
               node.create_index("vec-1"),
               node.create_index("vec-2", {"settings": {
                   "number_of_shards": 1}, "mappings": {"properties": {
                       "extra": {"type": "keyword"}}},
                   "aliases": {"mine": {}}}),
               node.get_mapping("vec-*"), node.get_settings("vec-*"),
               node.get_alias(), node.resolve_indices("all-vec")]
        return out

    out = pair.flow(scenario)
    assert out[11]["vec-1"]["settings"]["index"]["number_of_shards"] == "2"
    assert out[11]["vec-2"]["settings"]["index"]["number_of_shards"] == "1"
    assert set(out[10]["vec-2"]["mappings"]["properties"]) == {
        "v", "tag", "views", "extra"}
    assert out[13] == ["vec-1", "vec-2"]


def test_template_errors(pair):
    def scenario(node):
        return [observe(lambda: node.put_index_template("t", {})),
                observe(lambda: node.put_index_template("t", {
                    "index_patterns": ["a*"], "composed_of": ["nope"]})),
                observe(lambda: node.put_component_template("c", {})),
                observe(lambda: node.get_index_template("nope")),
                node.get_index_template("nope*"),
                observe(lambda: node.delete_index_template("nope")),
                observe(lambda: node.get_component_template("nope")),
                observe(lambda: node.delete_component_template("nope")),
                observe(lambda: node.put_legacy_template("l", {})),
                observe(lambda: node.get_legacy_templates("nope")),
                node.get_legacy_templates("nope*"),
                observe(lambda: node.delete_legacy_template("nope")),
                node.delete_legacy_template("nope*")]

    out = pair.flow(scenario)
    assert out[1][1] == "IllegalArgumentException"
    assert out[3][:3] == ("error", "ResourceNotFoundException", 404)


def test_legacy_templates_merge_by_order_and_shadowing(pair):
    def scenario(node):
        out = [node.put_legacy_template("base", {
            "index_patterns": "old-*", "order": 0,
            "settings": {"number_of_shards": 3, "refresh_interval": "1s"},
            "mappings": {"properties": {"a": {"type": "keyword"}}},
            "aliases": {"olds": {"routing": 7}}}),
            node.put_legacy_template("over", {
                "index_patterns": ["old-x*"], "order": 2, "version": 4,
                "settings": {"index": {"number_of_shards": 1}},
                "mappings": {"properties": {"b": {"type": "long"}}}}),
            observe(lambda: node.put_legacy_template(
                "over", {"index_patterns": ["z"]}, create=True)),
            node.get_legacy_templates(), node.get_legacy_templates("o*"),
            node.create_index("old-1"), node.create_index("old-x1"),
            node.get_settings("old-*"), node.get_mapping("old-*"),
            node.get_alias(index_expr="old-*")]
        # a composable template shadows every legacy one of its pattern
        out.append(node.put_index_template("new", {
            "index_patterns": ["old-y*"],
            "template": {"mappings": {"properties": {
                "c": {"type": "text"}}}}}))
        out.append(node.create_index("old-y1"))
        out.append(node.get_mapping("old-y1"))
        out.append(node.get_settings("old-y1"))
        out.append(node.delete_legacy_template("ov*"))
        out.append(node.get_legacy_templates())
        return out

    out = pair.flow(scenario)
    assert out[7]["old-x1"]["settings"]["index"]["number_of_shards"] == "1"
    assert set(out[8]["old-x1"]["mappings"]["properties"]) == {"a", "b"}
    assert set(out[12]["old-y1"]["mappings"]["properties"]) == {"c"}


def test_auto_created_index_takes_its_template(pair):
    def scenario(node):
        node.put_component_template("vecs", COMPONENT)
        node.put_index_template("vec", {"index_patterns": ["vec-*"],
                                        "composed_of": ["vecs"],
                                        "template": {"aliases": {
                                            "vec-all": {"is_write_index":
                                                        True}}}})
        out = [node.index_doc("vec-2026.10", "1",
                              {"v": [1.0, 0.0, 0.0, 0.0], "tag": "a"}),
               node.bulk([("index", {"_index": "vec-2026.11", "_id": "2"},
                           {"v": [0.0, 1.0, 0.0, 0.0], "tag": "b"})],
                         refresh=True),
               node.update_doc("vec-2026.12", "3", {
                   "doc": {"v": [0.0, 0.0, 1.0, 0.0]},
                   "doc_as_upsert": True}, refresh=True)]
        node.refresh("_all")
        out += [node.get_mapping("vec-*"), node.get_settings("vec-*"),
                node.get_alias(index_expr="vec-*"),
                node.search("vec-*", {"query": {"knn": {"v": {
                    "vector": [1.0, 0.1, 0.0, 0.0], "k": 3}}}})]
        return out

    out = pair.flow(scenario)
    assert len(out[6]["hits"]["hits"]) == 3
    for name in ("vec-2026.10", "vec-2026.11", "vec-2026.12"):
        assert out[4][name]["settings"]["index"]["number_of_shards"] == "2"


def test_restart_keeps_the_merged_template_result(tmp_path):
    """The index registry keeps what the template gave the index: after
    the template is deleted, a restart reopens the index with the
    template's mappings, settings and aliases, on both packages."""
    def scenario(cls, path, **kw):
        node = cls(path, **kw)
        node.put_component_template("vecs", COMPONENT)
        node.put_index_template("vec", {"index_patterns": ["vec-*"],
                                        "composed_of": ["vecs"],
                                        "template": {"aliases": {
                                            "va": {}}}})
        node.index_doc("vec-1", "1", {"v": [1.0, 2.0, 3.0, 4.0]},
                       refresh=True)
        node.delete_index_template("vec")
        node.delete_component_template("vecs")
        node.close()
        node = cls(path, **kw)
        try:
            return [node.get_mapping("vec-1"), node.get_settings("vec-1"),
                    node.get_alias(index_expr="vec-1"),
                    node.get_index_template("v*"),
                    node.search("va", {"query": {"knn": {"v": {
                        "vector": [1.0, 2.0, 3.0, 4.0], "k": 1}}}})]
        finally:
            node.close()

    ref = scenario(TpuNode, tmp_path / "ref")
    port = scenario(TorchNode, tmp_path / "port", device="cpu")
    from test_torch_scroll_pit import strip_contexts
    from test_torch_rest import _assert_same

    _assert_same(strip_contexts(ref), strip_contexts(port))
    assert port[0]["vec-1"]["mappings"]["properties"]["v"]["type"] in (
        "knn_vector", "dense_vector")
    assert port[1]["vec-1"]["settings"]["index"]["number_of_shards"] == "2"
    assert port[2] == {"vec-1": {"aliases": {"va": {}}}}
    assert port[4]["hits"]["hits"][0]["_id"] == "1"


def test_templates_persist_in_the_data_path(pair, tmp_path):
    def scenario(node):
        node.put_component_template("c", {"template": {"settings": {
            "number_of_shards": 1}}})
        node.put_index_template("t", {"index_patterns": ["t*"],
                                      "composed_of": ["c"]})
        node.put_legacy_template("l", {"index_patterns": ["l*"]})
        again = type(node)(node.data_path, **(
            {"device": "cpu"} if isinstance(node, TorchNode) else {}))
        try:
            return [again.get_index_template(), again.get_component_template(),
                    again.get_legacy_templates()]
        finally:
            again.close()

    out = pair.flow(scenario)
    assert out[0]["index_templates"][0]["name"] == "t"


def test_template_default_pipeline_runs_on_the_auto_creating_write(tmp_path):
    """The port resolves a template's default and final pipelines for an
    index the write is about to create (IngestService.resolvePipelines),
    so the first document is transformed too; the reference reads them
    from existing indices only and indexes that document raw."""
    def feed(node):
        node.ingest.put_pipeline("stamp", {"processors": [
            {"set": {"field": "stamped", "value": True}}]})
        node.put_index_template("t", {"index_patterns": ["logs-*"],
                                      "template": {"settings": {"index": {
                                          "default_pipeline": "stamp"}}}})
        node.bulk([("index", {"_index": "logs-1", "_id": str(i)}, {"i": i})
                   for i in range(3)], refresh=True)
        return [node.get_doc("logs-1", str(i))["_source"] for i in range(3)]

    port = TorchNode(tmp_path / "port", device="cpu")
    ref = TpuNode(tmp_path / "ref")
    try:
        assert feed(port) == [{"i": i, "stamped": True} for i in range(3)]
        assert feed(ref) == [{"i": 0}, {"i": 1, "stamped": True},
                             {"i": 2, "stamped": True}]
    finally:
        port.close()
        ref.close()
