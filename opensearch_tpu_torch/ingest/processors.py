"""Ingest processors: the transform vocabulary of ingest pipelines.

The analog of modules/ingest-common's processor set (~35 types) plus the
grok (libs/grok) and dissect (libs/dissect) parsers. Each processor factory
takes its JSON config and returns a Processor whose run(doc) mutates an
IngestDocument. Common options handled for every type: `if` (condition
script over ctx), `ignore_failure`, `on_failure` (nested processor chain),
`tag`, `description`.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import html
import json as _json
import re
import urllib.parse
from typing import Any, Callable

from opensearch_tpu_torch.common.errors import IllegalArgumentException
from opensearch_tpu_torch.ingest.document import IngestDocument

PROCESSOR_FACTORIES: dict[str, Callable] = {}


class DropDocument(Exception):
    """Raised by the drop processor: the document is discarded, not indexed."""


class IngestProcessorException(IllegalArgumentException):
    error_type = "ingest_processor_exception"


def register(name: str):
    def deco(fn):
        PROCESSOR_FACTORIES[name] = fn
        return fn
    return deco


class Processor:
    def __init__(self, typ: str, conf: dict, body: Callable, service=None):
        self.type = typ
        self.tag = conf.get("tag")
        self.description = conf.get("description")
        self.ignore_failure = bool(conf.get("ignore_failure", False))
        self.condition = conf.get("if")
        self._cond_compiled = None
        self.on_failure = [
            build_processor(p, service) for p in (conf.get("on_failure") or [])
        ]
        self.body = body

    def _condition_holds(self, doc: IngestDocument) -> bool:
        if self.condition is None:
            return True
        from opensearch_tpu_torch.script.painless import Evaluator
        from opensearch_tpu_torch.script.service import default_script_service as svc

        if self._cond_compiled is None:
            src = self.condition
            if isinstance(src, dict):
                src = src.get("source", "")
            self._cond_compiled = svc.compile(src)
        ast, params = self._cond_compiled
        try:
            out = Evaluator({"ctx": doc.ctx(), "params": params}).run(ast)
        finally:
            doc.finish_ctx()
        return bool(out)

    def run(self, doc: IngestDocument) -> None:
        if not self._condition_holds(doc):
            return
        try:
            self.body(doc)
        except DropDocument:
            raise
        except Exception as e:
            if self.on_failure:
                doc.ingest_meta["on_failure_message"] = str(e)
                doc.ingest_meta["on_failure_processor_type"] = self.type
                doc.ingest_meta["on_failure_processor_tag"] = self.tag
                for p in self.on_failure:
                    p.run(doc)
                return
            if self.ignore_failure:
                return
            raise IngestProcessorException(
                f"[{self.type}] {e}"
            ) from e


def build_processor(definition: dict, service=None) -> Processor:
    if len(definition) != 1:
        raise IllegalArgumentException(
            f"processor definition must name exactly one type, got "
            f"{sorted(definition)}"
        )
    typ = next(iter(definition))
    conf = definition[typ] or {}
    factory = PROCESSOR_FACTORIES.get(typ)
    if factory is None:
        raise IllegalArgumentException(f"No processor type exists with name [{typ}]")
    body = factory(conf, service)
    return Processor(typ, conf, body, service)


def _req(conf: dict, key: str) -> Any:
    if key not in conf:
        raise IllegalArgumentException(f"[{key}] required property is missing")
    return conf[key]


# -- mutate family ----------------------------------------------------------


@register("set")
def _set(conf, service):
    field = _req(conf, "field")
    override = conf.get("override", True)
    ignore_empty = conf.get("ignore_empty_value", False)
    copy_from = conf.get("copy_from")
    if copy_from is None:
        _req(conf, "value")

    def run(doc: IngestDocument):
        if not override and doc.get(field, default=None) is not None:
            return
        if copy_from is not None:
            value = doc.get(copy_from)
        else:
            value = doc.render(conf["value"])
        if ignore_empty and (value is None or value == ""):
            return
        doc.set(doc.render(field), value)
    return run


@register("append")
def _append(conf, service):
    field = _req(conf, "field")
    value = _req(conf, "value")
    allow_dup = conf.get("allow_duplicates", True)

    def run(doc: IngestDocument):
        v = value
        if isinstance(v, list):
            v = [doc.render(x) for x in v]
        else:
            v = doc.render(v)
        doc.append(doc.render(field), v, allow_duplicates=allow_dup)
    return run


@register("remove")
def _remove(conf, service):
    fields = _req(conf, "field")
    if isinstance(fields, str):
        fields = [fields]
    ignore_missing = conf.get("ignore_missing", False)

    def run(doc: IngestDocument):
        for f in fields:
            doc.remove(doc.render(f), ignore_missing=ignore_missing)
    return run


@register("rename")
def _rename(conf, service):
    field = _req(conf, "field")
    target = _req(conf, "target_field")
    ignore_missing = conf.get("ignore_missing", False)

    def run(doc: IngestDocument):
        src = doc.render(field)
        sentinel = object()
        v = doc.get(src, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{src}] doesn't exist")
        doc.remove(src)
        doc.set(doc.render(target), v)
    return run


_CONVERTERS = {
    "integer": lambda v: int(str(v), 0) if isinstance(v, str) else int(v),
    "long": lambda v: int(str(v), 0) if isinstance(v, str) else int(v),
    "float": float,
    "double": float,
    "string": lambda v: str(v).lower() if isinstance(v, bool) else str(v),
    "boolean": lambda v: _to_bool(v),
    "ip": lambda v: _valid_ip(v),
}


def _to_bool(v):
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s == "true":
        return True
    if s == "false":
        return False
    raise IllegalArgumentException(f"[{v}] is not a boolean value")


def _valid_ip(v):
    import ipaddress

    ipaddress.ip_address(str(v))
    return str(v)


def _auto_convert(v):
    if not isinstance(v, str):
        return v
    s = v.strip()
    if s.lower() == "true":
        return True
    if s.lower() == "false":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return v


@register("convert")
def _convert(conf, service):
    field = _req(conf, "field")
    typ = _req(conf, "type")
    target = conf.get("target_field", field)
    ignore_missing = conf.get("ignore_missing", False)
    if typ != "auto" and typ not in _CONVERTERS:
        raise IllegalArgumentException(f"type [{typ}] not supported")

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] doesn't exist")
        conv = _auto_convert if typ == "auto" else _CONVERTERS[typ]
        if isinstance(v, list):
            doc.set(target, [conv(x) for x in v])
        else:
            doc.set(target, conv(v))
    return run


def _strfmt_parse(value: str, fmt: str) -> _dt.datetime:
    if fmt == "ISO8601":
        txt = value.replace("Z", "+00:00")
        return _dt.datetime.fromisoformat(txt)
    if fmt == "UNIX":
        return _dt.datetime.fromtimestamp(float(value), _dt.timezone.utc)
    if fmt == "UNIX_MS":
        return _dt.datetime.fromtimestamp(float(value) / 1000, _dt.timezone.utc)
    # java time patterns -> strptime (common subset)
    py = (fmt.replace("yyyy", "%Y").replace("yy", "%y")
          .replace("MM", "%m").replace("dd", "%d")
          .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S")
          .replace("SSS", "%f").replace("XX", "%z").replace("Z", "%z"))
    return _dt.datetime.strptime(str(value), py)


@register("date")
def _date(conf, service):
    field = _req(conf, "field")
    formats = _req(conf, "formats")
    target = conf.get("target_field", "@timestamp")
    out_fmt = conf.get("output_format", "yyyy-MM-dd'T'HH:mm:ss.SSSXXX")

    def run(doc: IngestDocument):
        v = doc.get(field)
        last_err = None
        for fmt in formats:
            try:
                dt = _strfmt_parse(v, fmt)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=_dt.timezone.utc)
                if out_fmt.startswith("yyyy-MM-dd'T'"):
                    out = dt.isoformat(timespec="milliseconds").replace(
                        "+00:00", "Z")
                else:
                    out = dt.isoformat()
                doc.set(target, out)
                return
            except (ValueError, TypeError) as e:
                last_err = e
        raise IllegalArgumentException(
            f"unable to parse date [{v}]: {last_err}"
        )
    return run


@register("date_index_name")
def _date_index_name(conf, service):
    field = _req(conf, "field")
    rounding = _req(conf, "date_rounding")  # y M w d h m s
    prefix = conf.get("index_name_prefix", "")
    formats = conf.get("date_formats", ["ISO8601"])
    fmt_map = {"y": "%Y", "M": "%Y-%m", "d": "%Y-%m-%d", "h": "%Y-%m-%d-%H",
               "w": "%G-w%V", "m": "%Y-%m-%d-%H-%M", "s": "%Y-%m-%d-%H-%M-%S"}
    name_fmt = conf.get("index_name_format")

    def run(doc: IngestDocument):
        v = doc.get(field)
        dt = None
        for fmt in formats:
            try:
                dt = _strfmt_parse(v, fmt)
                break
            except (ValueError, TypeError):
                continue
        if dt is None:
            raise IllegalArgumentException(f"unable to parse date [{v}]")
        if name_fmt:
            suffix = dt.strftime(name_fmt.replace("yyyy", "%Y")
                                 .replace("MM", "%m").replace("dd", "%d"))
        else:
            suffix = dt.strftime(fmt_map[rounding])
        doc.meta["_index"] = f"{doc.render(prefix)}{suffix}"
    return run


def _simple_string_proc(name: str, fn: Callable[[str], Any]):
    @register(name)
    def _factory(conf, service, _fn=fn):
        field = _req(conf, "field")
        target = conf.get("target_field", field)
        ignore_missing = conf.get("ignore_missing", False)

        def run(doc: IngestDocument):
            sentinel = object()
            v = doc.get(field, default=sentinel)
            if v is sentinel or v is None:
                if ignore_missing:
                    return
                raise IllegalArgumentException(f"field [{field}] is null or missing")
            if isinstance(v, list):
                doc.set(target, [_fn(str(x)) for x in v])
            else:
                doc.set(target, _fn(str(v)))
        return run
    return _factory


_simple_string_proc("lowercase", str.lower)
_simple_string_proc("uppercase", str.upper)
_simple_string_proc("trim", str.strip)
_simple_string_proc("html_strip", lambda s: html.unescape(re.sub(r"<[^>]*>", "", s)))
_simple_string_proc("urldecode", urllib.parse.unquote)


_BYTES_RE = re.compile(r"(?i)^\s*(\d+(?:\.\d+)?)\s*(b|kb|mb|gb|tb|pb)\s*$")
_BYTES_MULT = {"b": 1, "kb": 1024, "mb": 1024**2, "gb": 1024**3,
               "tb": 1024**4, "pb": 1024**5}


def _parse_bytes(s: str) -> int:
    m = _BYTES_RE.match(s)
    if not m:
        raise IllegalArgumentException(f"failed to parse [{s}] as a byte size")
    return int(float(m.group(1)) * _BYTES_MULT[m.group(2).lower()])


_simple_string_proc("bytes", _parse_bytes)


@register("split")
def _split(conf, service):
    field = _req(conf, "field")
    sep = _req(conf, "separator")
    target = conf.get("target_field", field)
    ignore_missing = conf.get("ignore_missing", False)
    preserve = conf.get("preserve_trailing", False)

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] doesn't exist")
        parts = re.split(sep, str(v))
        if not preserve:
            while parts and parts[-1] == "":
                parts.pop()
        doc.set(target, parts)
    return run


@register("join")
def _join(conf, service):
    field = _req(conf, "field")
    sep = _req(conf, "separator")
    target = conf.get("target_field", field)

    def run(doc: IngestDocument):
        v = doc.get(field)
        if not isinstance(v, list):
            raise IllegalArgumentException(f"field [{field}] is not a list")
        doc.set(target, sep.join(str(x) for x in v))
    return run


@register("gsub")
def _gsub(conf, service):
    field = _req(conf, "field")
    pattern = re.compile(_req(conf, "pattern"))
    replacement = _req(conf, "replacement")
    target = conf.get("target_field", field)
    ignore_missing = conf.get("ignore_missing", False)

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] doesn't exist")
        doc.set(target, pattern.sub(replacement, str(v)))
    return run


@register("kv")
def _kv(conf, service):
    field = _req(conf, "field")
    field_split = _req(conf, "field_split")
    value_split = _req(conf, "value_split")
    target = conf.get("target_field")
    prefix = conf.get("prefix", "")
    include = conf.get("include_keys")
    exclude = conf.get("exclude_keys") or []
    ignore_missing = conf.get("ignore_missing", False)

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] doesn't exist")
        for pair in re.split(field_split, str(v)):
            if not pair:
                continue
            kv = re.split(value_split, pair, maxsplit=1)
            if len(kv) != 2:
                continue
            k, val = kv
            if include is not None and k not in include:
                continue
            if k in exclude:
                continue
            path = f"{target}.{prefix}{k}" if target else f"{prefix}{k}"
            doc.set(path, val)
    return run


@register("json")
def _json_proc(conf, service):
    field = _req(conf, "field")
    target = conf.get("target_field")
    add_to_root = conf.get("add_to_root", False)

    def run(doc: IngestDocument):
        v = doc.get(field)
        parsed = _json.loads(v) if isinstance(v, str) else v
        if add_to_root:
            if not isinstance(parsed, dict):
                raise IllegalArgumentException(
                    "cannot add non-object JSON to root"
                )
            doc.source.update(parsed)
        else:
            doc.set(target or field, parsed)
    return run


@register("csv")
def _csv(conf, service):
    import csv as _csvmod
    import io

    field = _req(conf, "field")
    target_fields = _req(conf, "target_fields")
    sep = conf.get("separator", ",")
    quote = conf.get("quote", '"')
    trim = conf.get("trim", False)
    empty_value = conf.get("empty_value")
    ignore_missing = conf.get("ignore_missing", False)

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] doesn't exist")
        row = next(_csvmod.reader(io.StringIO(str(v)), delimiter=sep,
                                  quotechar=quote))
        for name, val in zip(target_fields, row):
            if trim:
                val = val.strip()
            if val == "" and empty_value is not None:
                val = empty_value
            doc.set(name, val)
    return run


@register("dot_expander")
def _dot_expander(conf, service):
    field = _req(conf, "field")
    path = conf.get("path")

    def run(doc: IngestDocument):
        parent = doc.get(path) if path else doc.source
        if field == "*":
            keys = [k for k in list(parent) if "." in k]
        else:
            keys = [field] if field in parent else []
        for k in keys:
            v = parent.pop(k)
            node = parent
            parts = k.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return run


@register("sort")
def _sort(conf, service):
    field = _req(conf, "field")
    order = conf.get("order", "asc")
    target = conf.get("target_field", field)

    def run(doc: IngestDocument):
        v = doc.get(field)
        if not isinstance(v, list):
            raise IllegalArgumentException(f"field [{field}] is not a list")
        doc.set(target, sorted(v, reverse=(order == "desc")))
    return run


@register("fingerprint")
def _fingerprint(conf, service):
    fields = sorted(_req(conf, "fields"))
    target = conf.get("target_field", "fingerprint")
    method = conf.get("method", "SHA-1")
    ignore_missing = conf.get("ignore_missing", False)
    algos = {"MD5": "md5", "SHA-1": "sha1", "SHA-256": "sha256",
             "SHA-512": "sha512"}
    if method not in algos:
        raise IllegalArgumentException(f"[method] [{method}] not supported")

    def run(doc: IngestDocument):
        h = hashlib.new(algos[method])
        for f in fields:
            sentinel = object()
            v = doc.get(f, default=sentinel)
            if v is sentinel:
                if ignore_missing:
                    continue
                raise IllegalArgumentException(f"field [{f}] doesn't exist")
            h.update(f.encode())
            h.update(_json.dumps(v, sort_keys=True, default=str).encode())
        doc.set(target, h.hexdigest())
    return run


# -- control-flow family ----------------------------------------------------


@register("fail")
def _fail(conf, service):
    message = _req(conf, "message")

    def run(doc: IngestDocument):
        raise IllegalArgumentException(str(doc.render(message)))
    return run


@register("drop")
def _drop(conf, service):
    def run(doc: IngestDocument):
        raise DropDocument()
    return run


@register("foreach")
def _foreach(conf, service):
    field = _req(conf, "field")
    inner = build_processor(_req(conf, "processor"), service)
    ignore_missing = conf.get("ignore_missing", False)

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] doesn't exist")
        if isinstance(v, dict):
            for k in list(v):
                doc.ingest_meta["_key"] = k
                doc.ingest_meta["_value"] = v[k]
                inner.run(doc)
                v[doc.ingest_meta["_key"]] = doc.ingest_meta["_value"]
            doc.ingest_meta.pop("_key", None)
            doc.ingest_meta.pop("_value", None)
            return
        if not isinstance(v, list):
            raise IllegalArgumentException(f"field [{field}] is not a list")
        for i in range(len(v)):
            doc.ingest_meta["_value"] = v[i]
            inner.run(doc)
            v[i] = doc.ingest_meta["_value"]
        doc.ingest_meta.pop("_value", None)
    return run


@register("pipeline")
def _pipeline_proc(conf, service):
    name = _req(conf, "name")
    ignore_missing = conf.get("ignore_missing_pipeline", False)

    def run(doc: IngestDocument):
        if service is None:
            raise IllegalArgumentException("no ingest service bound")
        target = doc.render(name)
        pipe = service.get_compiled(target)
        if pipe is None:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"pipeline [{target}] does not exist")
        pipe.run(doc)
    return run


@register("script")
def _script(conf, service):
    from opensearch_tpu_torch.script.service import default_script_service as svc

    script = conf.get("source") or conf.get("script") or conf
    if isinstance(script, dict) and "source" not in script and "lang" in script:
        raise IllegalArgumentException("script processor requires [source]")
    compiled = svc.compile(script if isinstance(script, (str, dict)) else {})

    def run(doc: IngestDocument):
        ast, params = compiled
        try:
            svc.execute_ingest(ast, params, doc.ctx())
        finally:
            doc.finish_ctx()
    return run


# -- parsers: grok / dissect / uri / user_agent -----------------------------

GROK_BUILTINS = {
    "WORD": r"\b\w+\b",
    "NOTSPACE": r"\S+",
    "SPACE": r"\s*",
    "DATA": r".*?",
    "GREEDYDATA": r".*",
    "INT": r"[+-]?\d+",
    "NUMBER": r"[+-]?\d+(?:\.\d+)?",
    "BASE10NUM": r"[+-]?\d+(?:\.\d+)?",
    "POSINT": r"\d+",
    "IPV4": r"(?:\d{1,3}\.){3}\d{1,3}",
    "IPV6": r"[0-9A-Fa-f:]+:[0-9A-Fa-f:]*",
    "IP": r"(?:(?:\d{1,3}\.){3}\d{1,3}|[0-9A-Fa-f:]+:[0-9A-Fa-f:]*)",
    "HOSTNAME": r"\b[0-9A-Za-z][0-9A-Za-z-]{0,62}(?:\.[0-9A-Za-z][0-9A-Za-z-]{0,62})*\b",
    "IPORHOST": r"(?:(?:\d{1,3}\.){3}\d{1,3}|\b[0-9A-Za-z][0-9A-Za-z.-]*\b)",
    "USERNAME": r"[a-zA-Z0-9._-]+",
    "USER": r"[a-zA-Z0-9._-]+",
    "EMAILADDRESS": r"[a-zA-Z0-9._%+-]+@[a-zA-Z0-9.-]+",
    "UUID": r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}",
    "YEAR": r"\d{4}",
    "MONTHNUM": r"0?[1-9]|1[0-2]",
    "MONTHDAY": r"(?:0?[1-9]|[12]\d|3[01])",
    "HOUR": r"(?:[01]?\d|2[0-3])",
    "MINUTE": r"[0-5]\d",
    "SECOND": r"(?:[0-5]?\d)(?:\.\d+)?",
    "TIME": r"(?:[01]?\d|2[0-3]):[0-5]\d:(?:[0-5]?\d)(?:\.\d+)?",
    "TIMESTAMP_ISO8601": r"\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}:\d{2}(?:\.\d+)?(?:Z|[+-]\d{2}:?\d{2})?",
    "LOGLEVEL": r"(?:[Tt]race|TRACE|[Dd]ebug|DEBUG|[Ii]nfo|INFO|[Ww]arn(?:ing)?|WARN(?:ING)?|[Ee]rror|ERROR|[Ff]atal|FATAL)",
    "QS": r'"(?:[^"\\]|\\.)*"',
    "QUOTEDSTRING": r'"(?:[^"\\]|\\.)*"',
    "PATH": r"(?:/[\w.-]+)+",
    "URIPATH": r"(?:/[\w.;=@%&:!*'()\[\]~+#-]*)+",
    "HTTPMETHOD": r"(?:GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH|TRACE|CONNECT)",
}

_GROK_REF = re.compile(r"%\{(\w+)(?::([\w.\[\]@]+))?(?::(\w+))?\}")


def compile_grok(pattern: str, definitions: dict | None = None,
                 _depth: int = 0) -> tuple[re.Pattern, dict]:
    """Translate a grok pattern into a python regex; returns (regex,
    {group_name: (field, type)})."""
    if _depth > 10:
        raise IllegalArgumentException("grok pattern recursion too deep")
    defs = dict(GROK_BUILTINS)
    if definitions:
        defs.update(definitions)
    captures: dict[str, tuple[str, str | None]] = {}
    counter = [0]

    def sub(m):
        name, field, typ = m.group(1), m.group(2), m.group(3)
        base = defs.get(name)
        if base is None:
            raise IllegalArgumentException(f"Unable to find pattern [{name}]")
        # nested references inside the definition
        while _GROK_REF.search(base):
            base = _GROK_REF.sub(sub_nested, base)
        if field is None:
            return f"(?:{base})"
        counter[0] += 1
        gname = f"g{counter[0]}"
        captures[gname] = (field, typ)
        return f"(?P<{gname}>{base})"

    def sub_nested(m):
        name = m.group(1)
        base = defs.get(name)
        if base is None:
            raise IllegalArgumentException(f"Unable to find pattern [{name}]")
        field, typ = m.group(2), m.group(3)
        if field is None:
            return f"(?:{base})"
        counter[0] += 1
        gname = f"g{counter[0]}"
        captures[gname] = (field, typ)
        return f"(?P<{gname}>{base})"

    rx = _GROK_REF.sub(sub, pattern)
    return re.compile(rx), captures


@register("grok")
def _grok(conf, service):
    field = _req(conf, "field")
    patterns = _req(conf, "patterns")
    defs = conf.get("pattern_definitions")
    ignore_missing = conf.get("ignore_missing", False)
    trace = conf.get("trace_match", False)
    compiled = [compile_grok(p, defs) for p in patterns]

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel or v is None:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] is null or missing")
        for idx, (rx, captures) in enumerate(compiled):
            m = rx.search(str(v))
            if m is None:
                continue
            for gname, (fname, typ) in captures.items():
                val = m.group(gname)
                if val is None:
                    continue
                if typ == "int":
                    val = int(float(val))
                elif typ == "float":
                    val = float(val)
                doc.set(fname, val)
            if trace:
                doc.ingest_meta["_grok_match_index"] = str(idx)
            return
        raise IllegalArgumentException(
            f"Provided Grok expressions do not match field value: [{v}]"
        )
    return run


_DISSECT_KEY = re.compile(r"%\{([^}]*)\}")


@register("dissect")
def _dissect(conf, service):
    field = _req(conf, "field")
    pattern = _req(conf, "pattern")
    append_sep = conf.get("append_separator", "")
    ignore_missing = conf.get("ignore_missing", False)

    # parse into alternating literals and keys
    parts: list[tuple[str, str]] = []  # (kind, text): kind in lit|key
    pos = 0
    for m in _DISSECT_KEY.finditer(pattern):
        if m.start() > pos:
            parts.append(("lit", pattern[pos:m.start()]))
        parts.append(("key", m.group(1)))
        pos = m.end()
    if pos < len(pattern):
        parts.append(("lit", pattern[pos:]))

    rx_parts = []
    key_info: list[tuple[str, str]] = []  # (group, keyspec)
    for i, (kind, text) in enumerate(parts):
        if kind == "lit":
            rx_parts.append(re.escape(text))
        else:
            g = f"k{i}"
            last_key = all(k != "key" for k, _ in parts[i + 1:])
            rx_parts.append(f"(?P<{g}>.*)" if last_key else f"(?P<{g}>.*?)")
            key_info.append((g, text))
    rx = re.compile("^" + "".join(rx_parts) + "$")

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] doesn't exist")
        m = rx.match(str(v))
        if m is None:
            raise IllegalArgumentException(
                f"Unable to find match for dissect pattern: {pattern} "
                f"against source: {v}"
            )
        appends: dict[str, list[str]] = {}
        for g, spec in key_info:
            val = m.group(g)
            if spec == "" or spec.startswith("?"):
                continue  # skip key
            if spec.startswith("+"):
                appends.setdefault(spec[1:], []).append(val)
                continue
            doc.set(spec, val)
        for k, vals in appends.items():
            prev = doc.get(k, default=None)
            joined = append_sep.join(([str(prev)] if prev is not None else []) + vals)
            doc.set(k, joined)
    return run


@register("uri_parts")
def _uri_parts(conf, service):
    field = _req(conf, "field")
    target = conf.get("target_field", "url")
    keep_original = conf.get("keep_original", True)
    remove_if_successful = conf.get("remove_if_successful", False)

    def run(doc: IngestDocument):
        v = str(doc.get(field))
        u = urllib.parse.urlsplit(v)
        out: dict[str, Any] = {}
        if u.scheme:
            out["scheme"] = u.scheme
        if u.hostname:
            out["domain"] = u.hostname
        if u.port:
            out["port"] = u.port
        if u.path:
            out["path"] = u.path
            if "." in u.path.rsplit("/", 1)[-1]:
                out["extension"] = u.path.rsplit(".", 1)[-1]
        if u.query:
            out["query"] = u.query
        if u.fragment:
            out["fragment"] = u.fragment
        if u.username:
            out["username"] = u.username
        if u.password:
            out["password"] = u.password
            out["user_info"] = f"{u.username}:{u.password}"
        if keep_original:
            out["original"] = v
        doc.set(target, out)
        if remove_if_successful and field != target:
            doc.remove(field, ignore_missing=True)
    return run


_UA_BROWSERS = [
    ("Edge", re.compile(r"Edg(?:e|A|iOS)?/(\d+[\w.]*)")),
    ("Chrome Mobile", re.compile(r"Chrome/(\d+[\w.]*) Mobile")),
    ("Chrome", re.compile(r"Chrome/(\d+[\w.]*)")),
    ("Firefox", re.compile(r"Firefox/(\d+[\w.]*)")),
    ("Safari", re.compile(r"Version/(\d+[\w.]*).*Safari")),
    ("Opera", re.compile(r"(?:Opera|OPR)/(\d+[\w.]*)")),
    ("IE", re.compile(r"MSIE (\d+[\w.]*)")),
    ("curl", re.compile(r"curl/(\d+[\w.]*)")),
]
_UA_OS = [
    ("Windows", re.compile(r"Windows NT ([\d.]+)")),
    ("iOS", re.compile(r"iPhone OS ([\d_]+)")),
    ("Mac OS X", re.compile(r"Mac OS X ([\d_.]+)")),
    ("Android", re.compile(r"Android ([\d.]+)")),
    ("Linux", re.compile(r"Linux")),
]


@register("user_agent")
def _user_agent(conf, service):
    field = _req(conf, "field")
    target = conf.get("target_field", "user_agent")
    ignore_missing = conf.get("ignore_missing", False)

    def run(doc: IngestDocument):
        sentinel = object()
        v = doc.get(field, default=sentinel)
        if v is sentinel:
            if ignore_missing:
                return
            raise IllegalArgumentException(f"field [{field}] doesn't exist")
        ua = str(v)
        out: dict[str, Any] = {"name": "Other", "original": ua}
        for name, rx in _UA_BROWSERS:
            m = rx.search(ua)
            if m:
                out["name"] = name
                out["version"] = m.group(1)
                break
        for name, rx in _UA_OS:
            m = rx.search(ua)
            if m:
                ver = m.group(1).replace("_", ".") if rx.groups else None
                out["os"] = {"name": name, **({"version": ver} if ver else {})}
                break
        out["device"] = {
            "name": "Mobile" if re.search(r"Mobile|iPhone|Android", ua) else "Other"
        }
        doc.set(target, out)
    return run
