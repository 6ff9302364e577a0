"""The port's parameter structs, ``Config`` files, env reads and Registry
(``dmlc_tpu_torch/params``): the JAX package's ``tests/test_params.py``
cases (unittest_param.cc / unittest_config.cc / unittest_env.cc /
registry_test.cc coverage) run on the port, then the port held against
the JAX package: a saved struct loads in the other package, and a config
file reads the same."""

import io
import os

import pytest

from dmlc_tpu_torch.params import Config, ParamError, Parameter, Registry, field, get_env, set_env


class LearnerParam(Parameter):
    num_hidden = field(int, 64, lower_bound=1, description="hidden units")
    lr = field(float, 0.01, lower_bound=0.0, upper_bound=10.0, description="step size")
    act = field(str, "relu", enum={"relu": "relu", "tanh": "tanh", "sigmoid": "sigmoid"})
    use_bias = field(bool, True)
    name = field(str)  # required: no default
    seed = field(int, None, optional_none=True, description="optional seed")
    wd = field(float, 0.0, aliases=("weight_decay",))


def make(**kw):
    kw.setdefault("name", "m")
    return LearnerParam(**kw)


class TestParameter:
    def test_defaults_and_init(self):
        p = make(num_hidden="128", lr="0.1", use_bias="false")
        assert p.num_hidden == 128
        assert p.lr == pytest.approx(0.1)
        assert p.use_bias is False
        assert p.act == "relu"

    def test_required_missing(self):
        with pytest.raises(ParamError, match="Required parameter"):
            LearnerParam(num_hidden=3)

    def test_unknown_key_raises_with_doc(self):
        with pytest.raises(ParamError, match="num_hidden"):
            make(bogus=1)

    def test_allow_unknown_returns_extras(self):
        p = LearnerParam()
        unknown = p.init({"name": "x", "bogus": "1"}, allow_unknown=True)
        assert unknown == {"bogus": "1"}

    def test_allow_hidden(self):
        p = LearnerParam()
        p.init({"name": "x", "__hidden__": "z"}, allow_hidden=True)
        with pytest.raises(ParamError):
            LearnerParam().init({"name": "x", "__hidden__": "z"})

    def test_range_check(self):
        with pytest.raises(ParamError, match=">="):
            make(num_hidden=0)
        with pytest.raises(ParamError, match="<="):
            make(lr=100.0)

    def test_enum(self):
        assert make(act="tanh").act == "tanh"
        with pytest.raises(ParamError, match="expected one of"):
            make(act="gelu")

    def test_bool_parse(self):
        assert make(use_bias="1").use_bias is True
        assert make(use_bias="0").use_bias is False
        with pytest.raises(ParamError):
            make(use_bias="yes")

    def test_float_subnormal_rejected(self):
        # unittest_param.cc:13-21 — subnormal float literal must throw
        with pytest.raises(ParamError):
            make(lr="4.91e-41")

    def test_float_inf_nan_rejected(self):
        for bad in ("inf", "-inf", "nan", "0x1p-3"):
            with pytest.raises(ParamError):
                make(lr=bad)

    def test_optional_none(self):
        p = make()
        assert p.seed is None
        assert make(seed="7").seed == 7
        assert make(seed="None").seed is None
        assert p.to_dict()["seed"] == "None"

    def test_alias(self):
        assert make(weight_decay="0.5").wd == pytest.approx(0.5)

    def test_dict_roundtrip(self):
        p = make(num_hidden=3, act="tanh")
        q = LearnerParam(**p.to_dict())
        assert q == p

    def test_json_roundtrip(self):
        p = make(num_hidden=17, lr=0.25)
        buf = io.StringIO()
        p.save(buf)
        buf.seek(0)
        q = LearnerParam()
        q.load(buf)
        assert q == p

    def test_doc_string(self):
        doc = LearnerParam.__doc_string__()
        assert "num_hidden" in doc and "hidden units" in doc and "required" in doc

    def test_setattr_validates(self):
        p = make()
        with pytest.raises(ParamError):
            p.num_hidden = -2
        p.num_hidden = "12"
        assert p.num_hidden == 12


class TestRegistry:
    def test_register_find_alias(self):
        reg = Registry.get("test_reg_a")
        entry = reg.register("linear", lambda: "L").describe("linear model")
        assert reg.find("linear") is entry
        reg.add_alias("linear", "lin")
        assert reg.find("lin") is entry
        assert entry() == "L"
        assert set(reg.list_all_names()) == {"linear", "lin"}
        assert reg.list_entries() == [entry]

    def test_decorator_and_duplicate(self):
        reg = Registry.get("test_reg_b")

        @reg.register("f")
        def factory():
            return 1

        with pytest.raises(ParamError):
            reg.register("f", lambda: 2)
        with pytest.raises(ParamError, match="Unknown entry"):
            reg.lookup("nope")

    def test_singleton(self):
        assert Registry.get("test_reg_c") is Registry.get("test_reg_c")


class TestConfig:
    def test_basic(self):
        cfg = Config("a = 1\nb = two # comment\n# full comment\nc = 3")
        assert cfg.get_param("a") == "1"
        assert cfg.get_param("b") == "two"
        assert list(cfg) == [("a", "1"), ("b", "two"), ("c", "3")]

    def test_quoted_escapes(self):
        cfg = Config('msg = "hello \\"world\\"\\n" \n x = "a#b"')
        assert cfg.get_param("msg") == 'hello "world"\n'
        assert cfg.get_param("x") == "a#b"

    def test_multi_value(self):
        cfg = Config("k = 1\nk = 2", multi_value=True)
        assert cfg.get_all("k") == ["1", "2"]
        assert cfg.get_param("k") == "2"
        single = Config("k = 1\nk = 2")
        assert single.get_all("k") == ["2"]

    def test_proto_string(self):
        cfg = Config('a = 1\nmsg = "x\\ny"')
        assert cfg.to_proto_string() == 'a : "1"\nmsg : "x\\ny"\n'

    def test_errors(self):
        with pytest.raises(Exception):
            Config("key value")
        with pytest.raises(Exception):
            Config('k = "unterminated')


class TestEnv:
    def test_get_set(self):
        set_env("DMLC_TPU_TEST_INT", 42)
        assert os.environ["DMLC_TPU_TEST_INT"] == "42"
        assert get_env("DMLC_TPU_TEST_INT", 0) == 42
        set_env("DMLC_TPU_TEST_BOOL", True)
        assert os.environ["DMLC_TPU_TEST_BOOL"] == "true"
        assert get_env("DMLC_TPU_TEST_BOOL", False) is True
        assert get_env("DMLC_TPU_TEST_MISSING", 7) == 7


def _ref_param_class():
    from dmlc_tpu.params import Parameter as RefParameter
    from dmlc_tpu.params import field as ref_field

    class RefLearnerParam(RefParameter):
        num_hidden = ref_field(int, 64, lower_bound=1,
                               description="hidden units")
        lr = ref_field(float, 0.01, lower_bound=0.0, upper_bound=10.0,
                       description="step size")
        act = ref_field(str, "relu", enum={"relu": "relu", "tanh": "tanh",
                                           "sigmoid": "sigmoid"})
        use_bias = ref_field(bool, True)
        name = ref_field(str)
        seed = ref_field(int, None, optional_none=True,
                         description="optional seed")
        wd = ref_field(float, 0.0, aliases=("weight_decay",))

    return RefLearnerParam


@pytest.mark.parametrize("kwargs", [
    {"name": "m"},
    {"name": "n", "num_hidden": "7", "lr": "0.125", "act": "tanh",
     "use_bias": "0", "seed": "42", "weight_decay": "0.5"},
    {"name": "x y", "seed": "None", "lr": "1e-3"},
])
def test_saved_structs_load_in_either_package(kwargs):
    ref_cls = _ref_param_class()
    port = make(**kwargs)
    ref = ref_cls(**kwargs)
    assert port.saves() == ref.saves()
    assert port.to_dict() == ref.to_dict()
    back = ref_cls(name="z")
    back.loads(port.saves())
    assert back.to_dict() == port.to_dict()
    again = make()
    again.loads(ref.saves())
    assert again == port
    assert port.__doc_string__().replace("LearnerParam", "P") == \
        ref.__doc_string__().replace("RefLearnerParam", "P")


CONFIG_TEXT = """# a comment
lr = 0.1
name = "quoted \\"value\\" here"
layers = 3
layers = 4
empty=""
"""


@pytest.mark.parametrize("multi_value", [False, True])
def test_config_reads_as_the_jax_packages(multi_value):
    from dmlc_tpu.params import Config as RefConfig

    port = Config(io.StringIO(CONFIG_TEXT), multi_value=multi_value)
    ref = RefConfig(io.StringIO(CONFIG_TEXT), multi_value=multi_value)
    assert port.items() == ref.items()
    assert port.to_proto_string() == ref.to_proto_string()
    assert port.get_all("layers") == ref.get_all("layers")

