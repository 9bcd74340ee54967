"""The program's schema of a configuration: its registered dataset schema
of the configuration's columns (their types and tags), each categorical
domain set to the configuration's largest id and each list held to the
configuration's length (a program whose list columns moved is refused, not
measured); and the program's ``Dataset`` over drawn columns."""

from __future__ import annotations

from dataclasses import replace

from ..traffic import column_names


def program_schema(cfg: dict):
    from models_tpu_torch.data.synthetic import known_schema

    registered = known_schema(cfg["program_schema"])
    cols = []
    for col in cfg["columns"]:
        got = registered[col["name"]]
        if "max_id" in col:
            got = replace(got, int_domain=replace(got.int_domain, max=col["max_id"]))
        if "max_len" in col and got.max_seq_length != col["max_len"]:
            raise ValueError(f"{col['name']}: the program's list length {got.max_seq_length} "
                             f"is not the configuration's {col['max_len']}")
        cols.append(got)
    return type(registered)(cols)


def dataset(cfg: dict, data: dict):
    """The program's ``Dataset`` over the drawn columns ``data``."""
    import models_tpu_torch as mt

    schema = program_schema(cfg).select_by_name(column_names(data))
    return mt.Dataset(data, schema=schema)
