"""The port's streaming JSON layer (``dmlc_tpu_torch/io/json.py``, json.h
parity: reader json.h:43, writer json.h:188, declare-fields helper
json.h:310): the JAX package's ``tests/test_json.py`` cases run on the
port, then the port's text held against the JAX package's both ways."""

import json as stdlib_json

import pytest

from dmlc_tpu_torch.io.json import (
    JSONObjectReadHelper,
    JSONReader,
    JSONWriter,
    dump,
    dumps,
    load,
    loads,
)
from dmlc_tpu_torch.utils.logging import DMLCError


class TestReader:
    def test_pull_tokenizer_object(self):
        reader = JSONReader('{"a": 1, "b": "two", "c": [3, 4]}')
        reader.begin_object()
        seen = {}
        while (key := reader.next_object_item()) is not None:
            seen[key] = reader.read_value()
        assert seen == {"a": 1, "b": "two", "c": [3, 4]}

    def test_pull_tokenizer_array(self):
        reader = JSONReader(" [1, 2.5, -3e2] ")
        reader.begin_array()
        items = []
        while reader.next_array_item():
            items.append(reader.read_number())
        assert items == [1, 2.5, -300.0]
        assert isinstance(items[0], int)

    def test_strings_with_escapes(self):
        assert loads(r'"a\nb\t\"q\" é"') == 'a\nb\t"q" é'

    def test_nested_value(self):
        doc = {"x": [1, {"y": None, "z": [True, False]}], "s": "str"}
        assert loads(stdlib_json.dumps(doc)) == doc

    def test_streaming_from_stream(self, tmp_path):
        p = tmp_path / "d.json"
        p.write_text('{"k": [1, 2, 3]}')
        with open(p) as fh:
            assert load(fh) == {"k": [1, 2, 3]}

    def test_error_reports_line(self):
        with pytest.raises(DMLCError, match="line 3"):
            loads('{\n"a": 1,\n"b": }\n')

    def test_unterminated(self):
        with pytest.raises(DMLCError):
            loads('{"a": "unclosed')


class TestWriter:
    def test_round_trip_python_tree(self):
        doc = {
            "name": "dmlc", "n": 42, "pi": 3.25, "flag": True,
            "none": None, "list": [1, "two", {"three": 3}],
        }
        text = dumps(doc)
        assert loads(text) == doc
        assert stdlib_json.loads(text) == doc  # interoperable output

    def test_structured_api(self):
        writer = JSONWriter()
        writer.begin_object()
        writer.write_object_keyvalue("a", 1)
        writer.write_object_keyvalue("b", [1, 2])
        writer.end_object()
        assert stdlib_json.loads(writer.getvalue()) == {"a": 1, "b": [1, 2]}

    def test_escaping(self):
        text = dumps({"k": 'quote " back \\ ctrl \x01 nl \n'})
        assert stdlib_json.loads(text) == {"k": 'quote " back \\ ctrl \x01 nl \n'}

    def test_write_to_byte_stream(self, tmp_path):
        from dmlc_tpu_torch.io.filesystem import create_stream

        uri = str(tmp_path / "out.json")
        with create_stream(uri, "w") as out:
            dump({"a": [1, 2]}, out)
        assert stdlib_json.loads(open(uri).read()) == {"a": [1, 2]}

    def test_unencodable(self):
        with pytest.raises(DMLCError, match="cannot encode"):
            dumps({"bad": object()})


class TestDeclareFields:
    def test_required_and_optional(self):
        helper = JSONObjectReadHelper()
        helper.declare_field("name", str)
        helper.declare_field("value", float)
        helper.declare_optional_field("count", int, default=7)
        out = helper.read_all_fields(
            JSONReader('{"name": "x", "value": 2.5}')
        )
        assert out == {"name": "x", "value": 2.5, "count": 7}

    def test_unknown_field_rejected(self):
        helper = JSONObjectReadHelper()
        helper.declare_field("a", int)
        with pytest.raises(DMLCError, match="unknown field 'b'"):
            helper.read_all_fields(JSONReader('{"a": 1, "b": 2}'))

    def test_missing_required_rejected(self):
        helper = JSONObjectReadHelper()
        helper.declare_field("a", int)
        with pytest.raises(DMLCError, match="required field 'a'"):
            helper.read_all_fields(JSONReader("{}"))

    def test_type_mismatch_rejected(self):
        helper = JSONObjectReadHelper()
        helper.declare_field("a", int)
        with pytest.raises(DMLCError, match="expected int"):
            helper.read_all_fields(JSONReader('{"a": "nope"}'))

    def test_custom_reader_callable(self):
        def read_pairs(reader):
            reader.begin_object()
            out = {}
            while (key := reader.next_object_item()) is not None:
                out[key] = reader.read_value()
            return out

        helper = JSONObjectReadHelper()
        helper.declare_field("pairs", read_pairs)
        out = helper.read_all_fields(
            JSONReader('{"pairs": {"x": 1, "y": 2}}')
        )
        assert out["pairs"] == {"x": 1, "y": 2}


class TestParameterCallSite:
    def test_parameter_save_load_round_trip(self, tmp_path):
        from dmlc_tpu_torch.params import Parameter, field

        class P(Parameter):
            lr = field(float, 0.1)
            name = field(str, "model")
            n = field(int, 4)

        p = P()
        p.init({"lr": "0.5", "name": "quoted \" name", "n": "9"})
        path = tmp_path / "p.json"
        with open(path, "w") as fh:
            p.save(fh)
        q = P()
        with open(path) as fh:
            q.load(fh)
        assert q.lr == 0.5 and q.name == 'quoted " name' and q.n == 9
        # saves/loads string surface
        r = P()
        r.loads(p.saves())
        assert r.to_dict() == p.to_dict()


class TestEncodingEdges:
    def test_multibyte_utf8_over_byte_stream(self, tmp_path):
        """Reader regression: multi-byte characters split across read(1)
        calls on a binary stream must decode (review finding)."""
        import io

        doc = {"k": "é ü 漢字"}
        assert load(io.BytesIO(dumps(doc).encode())) == doc

    def test_surrogate_pairs_from_ensure_ascii(self):
        """stdlib ensure_ascii encodes non-BMP chars as surrogate pairs;
        the reader must combine them (review finding)."""
        emoji = "\U0001F600"
        text = stdlib_json.dumps({"k": emoji})  # -> 😀
        assert "\\ud83d" in text
        out = loads(text)
        assert out == {"k": emoji}
        # and the combined string re-saves cleanly to a byte sink
        import io

        sink = io.BytesIO()
        dump(out, sink)
        assert stdlib_json.loads(sink.getvalue()) == {"k": emoji}

    def test_lone_surrogate_rejected(self):
        with pytest.raises(DMLCError, match="surrogate"):
            loads('"\\ud83d oops"')

    def test_nonfinite_float_rejected_at_write(self):
        with pytest.raises(DMLCError, match="non-finite"):
            dumps({"bad": float("inf")})
        with pytest.raises(DMLCError, match="non-finite"):
            dumps(float("nan"))

    def test_non_writable_sink_rejected(self):
        from dmlc_tpu_torch.io.json import JSONWriter

        with pytest.raises(TypeError, match="writable"):
            JSONWriter("/some/path.json")


TREES = [
    {"a": 1, "b": "two", "c": [3, 4.5, -6e-7], "d": {"e": None,
                                                   "f": True}},
    [1, [2, [3, []]], {}, "x\ty\"z\u00e9"],
    "plain",
    -12.75,
    {"nested": [{"k": [0.1, 1e30, -0.0]}, {"k": []}], "empty": {}},
]


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("indent", [0, 2])
def test_text_equals_the_jax_packages(tree, indent):
    from dmlc_tpu.io import json as ref

    text = dumps(tree, indent=indent)
    assert text == ref.dumps(tree, indent=indent)
    assert ref.loads(text) == tree
    assert loads(ref.dumps(tree, indent=indent)) == tree

