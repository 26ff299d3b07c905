"""Named custom-generator factories (the serialization registry).

The reference serializes witness generators through per-type
WitnessGeneratorSerializers (util/serialization/generator_serialization.rs:10,
`impl_generator_serializer!`).  Here every `kind="custom"` GeneratorSpec
carries a registry `name` + plain-data `params`; the factory below rebuilds
the closure from (params, luts) on deserialization.  User-defined generators
register with `@register_custom("name")` before reading a checkpoint (same
contract as the reference: deserialization needs the serializer that knows
the type).
"""

from __future__ import annotations

import numpy as np

from ..field import gl64, gl64ext

CUSTOM_GENERATORS: dict = {}


def register_custom(name: str):
    def deco(factory):
        CUSTOM_GENERATORS[name] = factory
        return factory
    return deco


def build_custom_fn(name: str, params: tuple, luts: list):
    """Rebuild a custom generator fn from its registry entry."""
    if name not in CUSTOM_GENERATORS:
        raise ValueError(
            f"custom generator {name!r} is not registered; import the module "
            "that defines it (register_custom) before deserializing")
    return CUSTOM_GENERATORS[name](params, luts)


@register_custom("inv_ext")
def _inv_ext(params, luts):
    def compute_inv(dep_vals):
        return gl64ext.inv(dep_vals.reshape(2))
    return compute_inv


@register_custom("le_sum")
def _le_sum(params, luts):
    def compute_sum(dep_vals):
        acc = 0
        for v in reversed(dep_vals.tolist()):
            acc = (acc * 2 + int(v)) % gl64.ORDER_INT
        return [acc]
    return compute_sum


@register_custom("random_access_value")
def _random_access_value(params, luts):
    def compute_claimed(dep_vals):
        idx = int(dep_vals[0])
        return [int(dep_vals[1 + idx])]
    return compute_claimed


@register_custom("coset_interp")
def _coset_interp(params, luts):
    subgroup_bits, degree = params
    from .gates.interpolation import CosetInterpolationGate
    gate = CosetInterpolationGate(subgroup_bits, 1 << subgroup_bits)
    gate._degree = degree
    return gate.make_interpolant_fn()


@register_custom("lookup_output")
def _lookup_output(params, luts):
    (lut_index,) = params
    table_map = {}
    for a, b in luts[lut_index]:
        table_map.setdefault(a, b)

    def probe(dep_vals: np.ndarray) -> list:
        return [table_map[int(gl64.to_canonical(np.uint64(dep_vals[0])))]]
    return probe


@register_custom("lookup_mult")
def _lookup_mult(params, luts):
    lut_index, pad_count = params
    lut_pairs = list(luts[lut_index])
    inputs_index = {int(inp): i for i, (inp, _) in enumerate(lut_pairs)}

    def count(dep_vals: np.ndarray) -> list:
        mult = np.zeros(len(lut_pairs), dtype=np.uint64)
        for v in gl64.to_canonical(np.asarray(dep_vals, dtype=np.uint64)):
            mult[inputs_index[int(v)]] += 1
        mult[0] += pad_count
        return list(mult)
    return count
