"""Layered arithmetic circuits (structure-of-arrays, device evaluation).

Counterpart of :mod:`tpu_zk.circuit.layered`.  Each layer stores its gates
as index arrays (lefts / rights / outs / ops); evaluation is a gather of
both inputs, a K3 add and a K1 multiply with a select, and an exact
segment sum into the output slots (the reference's ``+=`` at
``output_index``, ``circuit/src/arithmetic_circuit.rs:65-109``).

The add_i/mul_i wiring indicators exist in two forms: sparse position lists
(:meth:`Circuit.gate_positions`, the linear-time prover's) and the dense MLE
tables of the reference's ``add_i_and_mul_i_mle`` (:126-163), packing
``(out | left | right)`` with widths ``(i, i+1, i+1)`` (layer 0:
``(1, 1, 1)``, :166-178), for the dense GKR pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..fields import arith
from ..fields.arith import FieldCtx
from ..poly.multilinear import MultilinearPolynomial

ADD = 0
MUL = 1


@dataclass
class Gate:
    left_index: int
    right_index: int
    output_index: int
    operator: int  # ADD or MUL

    @classmethod
    def add(cls, l, r, o):
        return cls(l, r, o, ADD)

    @classmethod
    def mul(cls, l, r, o):
        return cls(l, r, o, MUL)


class Layer:
    def __init__(self, gates: list[Gate]):
        self._set_arrays(
            [g.left_index for g in gates],
            [g.right_index for g in gates],
            [g.output_index for g in gates],
            [g.operator for g in gates],
        )

    @classmethod
    def from_arrays(cls, lefts, rights, outs, ops) -> "Layer":
        """Array-native constructor (no per-gate Python objects), for
        2^20+-gate layers."""
        layer = cls.__new__(cls)
        layer._set_arrays(lefts, rights, outs, ops)
        return layer

    def _set_arrays(self, lefts, rights, outs, ops) -> None:
        self.lefts = np.asarray(lefts, np.int32)
        self.rights = np.asarray(rights, np.int32)
        self.outs = np.asarray(outs, np.int32)
        self.ops = np.asarray(ops, np.int32)
        if not self.lefts.shape == self.rights.shape == self.outs.shape == self.ops.shape:
            raise ValueError("lefts, rights, outs and ops must have one length")
        self.width = int(self.outs.max()) + 1 if self.outs.size else 1
        self._on_device: dict[torch.device, tuple[torch.Tensor, ...]] = {}

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(lefts, rights, outs) as int64 index tensors and ``is_add [G, 1]``
        as a bool mask, on ``device`` (copied once per device, then cached)."""
        device = torch.device(device)
        if device not in self._on_device:
            idx = [torch.from_numpy(a.astype(np.int64)).to(device) for a in (self.lefts, self.rights, self.outs)]
            is_add = torch.from_numpy(self.ops == ADD).to(device)[:, None]
            self._on_device[device] = (*idx, is_add)
        return self._on_device[device]


@dataclass
class CircuitEvaluationResult:
    """The output layer as host ints, every layer as host ints (only the
    output layer when evaluated with ``materialize=False``), and every
    layer's Montgomery table on the device; output layer first, inputs
    last."""

    output: list[int]
    layer_evaluations: list[list[int]]
    layer_tables: list[torch.Tensor]


class Circuit:
    """layers[0] is the output layer, as in the reference."""

    def __init__(self, ctx: FieldCtx, layers: list[Layer]):
        self.ctx = ctx
        self.layers = layers

    def evaluate(self, values, materialize: bool = True, device=None) -> CircuitEvaluationResult:
        """``values``: a Montgomery ``[N, L]`` tensor (evaluated on its
        device), or host ints (evaluated on ``device``, by default the
        package's default device).

        ``materialize=False`` brings only the output layer to the host:
        converting 2^24 limb rows to Python ints costs minutes, and the
        protocols need only the output.
        """
        ctx = self.ctx
        current = values if isinstance(values, torch.Tensor) else ctx.array(list(values), device=device)
        tables = [current]
        for layer in reversed(self.layers):
            current = _eval_layer(ctx, current, layer)
            tables.append(current)
        tables.reverse()
        output = ctx.to_ints(tables[0].reshape(-1, ctx.L))
        evaluations = [ctx.to_ints(t.reshape(-1, ctx.L)) for t in tables] if materialize else [output]
        return CircuitEvaluationResult(output=output, layer_evaluations=evaluations, layer_tables=tables)

    def gate_positions(self, layer_index: int):
        """Sparse (positions, ops) of the wiring indicators for a layer,
        packed ``(out | left | right)`` as the reference's dense MLE index."""
        layer = self.layers[layer_index]
        b_bits = layer_index + 1
        pos = (
            (layer.outs.astype(np.int64) << (2 * b_bits))
            | (layer.lefts.astype(np.int64) << b_bits)
            | layer.rights.astype(np.int64)
        )
        return pos, layer.ops

    def wiring_table(self, layer_index: int, device=None) -> torch.Tensor:
        """The dense add_i and mul_i MLE tables of a layer as one
        ``[2, 2^(3i+2), L]`` Montgomery tensor (add_i first), built on
        ``device`` (by default the package's default device).

        One zeroed tensor and one scatter of the Montgomery one at the
        packed gate positions: the same integers as the reference's two
        tables of 0/1, with no host ints and no stack of two tables.  Index
        arithmetic is int64 (a depth-9 circuit's layer 8 holds 2^31 limbs).
        """
        ctx = self.ctx
        device = resolve(device)
        size = 1 << num_of_layer_variables(layer_index)
        pos, ops = self.gate_positions(layer_index)
        wired = (ops == ADD) | (ops == MUL)
        rows = torch.from_numpy(ops[wired].astype(np.int64) * size + pos[wired]).to(device)
        pair = torch.zeros((2, size, ctx.L), dtype=torch.int32, device=device)
        pair.view(-1, ctx.L)[rows] = ctx.one_mont(device)
        return pair

    def add_i_and_mul_i_mle(self, layer_index: int, device=None):
        """Dense indicator MLEs (reference arithmetic_circuit.rs:126-163), two
        views of :meth:`wiring_table`.

        Size 2^(3i+2) explodes for deep layers; the sparse representation in
        :meth:`gate_positions` is the scalable path.
        """
        pair = self.wiring_table(layer_index, device)
        return MultilinearPolynomial(self.ctx, pair[0]), MultilinearPolynomial(self.ctx, pair[1])

    def w_i_polynomial(self, circuit_evaluation: CircuitEvaluationResult, layer_index: int) -> MultilinearPolynomial:
        if layer_index >= len(circuit_evaluation.layer_tables):
            raise IndexError("layer index out of bounds")
        return MultilinearPolynomial(self.ctx, circuit_evaluation.layer_tables[layer_index])


def _eval_layer(ctx: FieldCtx, current: torch.Tensor, layer: Layer) -> torch.Tensor:
    """One layer: [N, L] Montgomery inputs -> [layer.width, L] outputs."""
    lefts, rights, outs, is_add = layer.on(current.device)
    left_vals = current[lefts]
    right_vals = current[rights]
    added = arith.add(ctx, left_vals, right_vals)
    mulled = arith.mont_mul(ctx, left_vals, right_vals)
    return arith.mont_segment_sum(ctx, torch.where(is_add, added, mulled), outs, layer.width)


def tree_sum_circuit(ctx: FieldCtx, depth: int, op: int = ADD) -> Circuit:
    """Balanced binary reduction circuit: 2^depth inputs, layer i has 2^i
    gates (2^depth - 1 in all) -- the BASELINE config-5 shape."""
    layers = []
    for i in range(depth):
        n = 1 << i
        idx = np.arange(n, dtype=np.int32)
        layers.append(Layer.from_arrays(2 * idx, 2 * idx + 1, idx, np.full(n, op, np.int32)))
    return Circuit(ctx, layers)


def num_of_layer_variables(layer_index: int) -> int:
    """Reference arithmetic_circuit.rs:166-178."""
    if layer_index == 0:
        return 3
    return layer_index + 2 * (layer_index + 1)


def convert_to_binary_and_to_decimal(layer_index, variable_a, variable_b, variable_c) -> int:
    """Reference arithmetic_circuit.rs:180-196 packing, arithmetically."""
    b_bits = layer_index + 1
    return (variable_a << (2 * b_bits)) | (variable_b << b_bits) | variable_c
