"""The Parameter module example (the reference's example/parameter.cc),
the counterpart of ``examples/parameter.py``; host only::

    python -m dmlc_tpu_torch.examples.parameter num_hidden=100 name=aaa \\
        activation=relu

With no arguments it prints the generated docstring; a bad value
(``activation=tanh``, ``num_hidden=-1``) prints the constraint error and
exits 1.
"""

import sys

from dmlc_tpu_torch.params import ParamError, Parameter, field


class MyParam(Parameter):
    num_hidden = field(
        int, lower_bound=0, upper_bound=1000,
        description="Number of hidden units in the fully connected layer.",
        aliases=["nhidden"],  # nhidden=... sets it too
    )
    learning_rate = field(
        float, 0.01, description="Learning rate of SGD optimization."
    )
    activation = field(
        int, enum={"relu": 1, "sigmoid": 2},
        description="Activation function type.", aliases=["act"],
    )
    name = field(str, "mnet", description="Name of the net.")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: parameter.py key=value ...")
        print("example: parameter.py num_hidden=100 name=aaa activation=relu")
        print()
        print("parameters:")
        print(MyParam.__doc_string__())
        return 1
    kwargs = dict(kv.split("=", 1) for kv in argv)
    param = MyParam()
    try:
        param.init(kwargs)
    except ParamError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    print(f"param.num_hidden={param.num_hidden}")
    print(f"param.learning_rate={param.learning_rate}")
    print(f"param.activation={param.activation}")
    print(f"param.name={param.name}")
    print(f"as dict: {param.to_dict()}")
    print(f"as json: {param.saves()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
