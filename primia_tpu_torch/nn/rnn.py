"""Share-capable recurrent layers: the RNN, GRU and LSTM cells and the
multi-layer, optionally bidirectional wrapper.

Port of ``primia_tpu/nn/rnn.py``. The cells are functions over an engine,
so one definition runs on plain tensors (:data:`PLAIN`) and over additive
shares (``mpc.engine.MpcEngine``, whose ``sigmoid`` and ``tanh`` are the
Chebyshev approximations of ``mpc/functions.py``). The same math as the
JAX package's cells, in its gate order:

- RNN: ``h' = act(W_xh x + b_xh + W_hh h + b_hh)``;
- GRU: reset, update and candidate chunks; ``h' = n + z (h - n)``;
- LSTM: i, f, g, o chunks; the forget-gate biases start at 1 / hidden.

Weights are in PyTorch's ``(out, in)`` layout, as ``nn.LSTM``'s
``weight_ih_l0`` (``wxh``: (chunks * hidden, in), ``whh``: (chunks *
hidden, hidden)); ``nn/jax_params.py:rnn_from_jax`` carries the JAX
package's ``(in, out)`` parameters across. The time loop is a Python loop
under both engines: under the MPC engine each step draws fresh dealer
randomness from the context, in step order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NUM_CHUNKS = {"rnn": 1, "gru": 3, "lstm": 4}


class PlainEngine:
    """The ops the cells use, on plain tensors (T, B, F)."""

    name = "plain"

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def add(self, x, y):
        return x + y

    def mul(self, x, y):
        return x * y

    def sigmoid(self, x):
        return torch.sigmoid(x)

    def tanh(self, x):
        return torch.tanh(x)

    def relu(self, x):
        return torch.relu(x)

    def split_last(self, x, k: int):
        if x.shape[-1] % k:
            raise ValueError(f"split_last: last dim {x.shape[-1]} not divisible by {k}")
        return x.chunk(k, dim=-1)

    def concat_last(self, xs):
        return torch.cat(xs, dim=-1)

    def zeros(self, shape, like):
        return like.new_zeros(shape)

    def time_slice(self, x, t: int):
        return x[t]

    def stack_time(self, xs):
        return torch.stack(xs)

    def swap_time_batch(self, x):
        return x.transpose(0, 1)


PLAIN = PlainEngine()


# ----------------------------------------------------------------- init

def cell_init(gen: torch.Generator, input_size: int, hidden_size: int, kind: str = "lstm",
              bias: bool = True, dtype=torch.float32):
    """One cell's parameters on ``gen``'s device: U(-1/sqrt(h), 1/sqrt(h));
    an LSTM's forget-gate biases (the second chunk) set to 1 / hidden."""
    k = NUM_CHUNKS[kind]
    std = 1.0 / math.sqrt(hidden_size)

    def uniform(*shape):
        u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
        return u * (2 * std) - std

    p = {"wxh": uniform(k * hidden_size, input_size),
         "whh": uniform(k * hidden_size, hidden_size)}
    if bias:
        p["bxh"] = uniform(k * hidden_size)
        p["bhh"] = uniform(k * hidden_size)
        if kind == "lstm":
            for b in ("bxh", "bhh"):
                p[b][hidden_size:2 * hidden_size] = 1.0 / hidden_size
    return p


def rnn_init(gen: torch.Generator, input_size: int, hidden_size: int, num_layers: int = 1,
             kind: str = "lstm", bias: bool = True, bidirectional: bool = False,
             dtype=torch.float32):
    """``{"fwd": [cell, ...], "bwd": [...]}``, one cell a layer and
    direction; a layer past the first reads both directions' outputs."""
    sizes = [input_size] + [hidden_size * (2 if bidirectional else 1)] * (num_layers - 1)
    params = {"fwd": [cell_init(gen, sz, hidden_size, kind, bias, dtype) for sz in sizes]}
    if bidirectional:
        params["bwd"] = [cell_init(gen, sz, hidden_size, kind, bias, dtype) for sz in sizes]
    return params


# ---------------------------------------------------------------- cells

def _gates(E, p, x, h):
    return E.linear(x, p["wxh"], p.get("bxh")), E.linear(h, p["whh"], p.get("bhh"))


def _sub(E, a, b):
    """a - b under either engine (both engines' add is linear)."""
    if E.name == "plain":
        return a - b
    return E.add(a, type(b)(-b.data))


def rnn_cell(E, p, x, h, nonlinearity: str = "tanh"):
    gx, gh = _gates(E, p, x, h)
    s = E.add(gx, gh)
    return E.tanh(s) if nonlinearity == "tanh" else E.relu(s)


def gru_cell(E, p, x, h):
    gx, gh = _gates(E, p, x, h)
    x_r, x_z, x_n = E.split_last(gx, 3)
    h_r, h_z, h_n = E.split_last(gh, 3)
    r = E.sigmoid(E.add(x_r, h_r))
    z = E.sigmoid(E.add(x_z, h_z))
    n = E.tanh(E.add(x_n, E.mul(r, h_n)))
    return E.add(n, E.mul(z, _sub(E, h, n)))


def lstm_cell(E, p, x, hc):
    """Returns (h', c')."""
    h, c = hc
    gx, gh = _gates(E, p, x, h)
    x_i, x_f, x_g, x_o = E.split_last(gx, 4)
    h_i, h_f, h_g, h_o = E.split_last(gh, 4)
    i = E.sigmoid(E.add(x_i, h_i))
    f = E.sigmoid(E.add(x_f, h_f))
    g = E.tanh(E.add(x_g, h_g))
    o = E.sigmoid(E.add(x_o, h_o))
    c_ = E.add(E.mul(f, c), E.mul(i, g))
    return E.mul(o, E.tanh(c_)), c_


# ------------------------------------------------------------ the layer

def _step(E, cells, x_t, states, kind, nonlinearity):
    """One time step through the layer stack: the new states and the top
    layer's output."""
    new_states = []
    inp = x_t
    for p, st in zip(cells, states):
        if kind == "lstm":
            st = lstm_cell(E, p, inp, st)
            inp = st[0]
        else:
            st = gru_cell(E, p, inp, st) if kind == "gru" else rnn_cell(E, p, inp, st,
                                                                          nonlinearity)
            inp = st
        new_states.append(st)
    return new_states, inp


def _run_direction(E, cells, x, states, kind, nonlinearity, reverse):
    seq_len = x.shape[0]
    outs = [None] * seq_len
    for t in (range(seq_len - 1, -1, -1) if reverse else range(seq_len)):
        states, outs[t] = _step(E, cells, E.time_slice(x, t), states, kind, nonlinearity)
    return states, E.stack_time(outs)


def rnn_apply(E, params, x, hc=None, *, kind: str = "lstm", nonlinearity: str = "tanh",
              batch_first: bool = False):
    """Run the whole RNN. ``x``: (T, B, F), or (B, T, F) with
    ``batch_first`` (an ``AShare`` with the party axis in front under the
    MPC engine). Returns ``(output, finals)``: output (T, B, H *
    directions) and the final states, one a layer and direction ((h, c)
    for an LSTM), ordered [fwd_0, ..., fwd_L, bwd_0, ..., bwd_L]."""
    if batch_first:
        x = E.swap_time_batch(x)
    batch = x.shape[1]
    hidden = params["fwd"][0]["whh"].shape[-1]

    def init_states(cells):
        z = E.zeros((batch, hidden), x)
        return [(z, z) if kind == "lstm" else z for _ in cells]

    n = len(params["fwd"])
    bidirectional = "bwd" in params
    st_f = init_states(params["fwd"]) if hc is None else list(hc[:n])
    st_f, out = _run_direction(E, params["fwd"], x, st_f, kind, nonlinearity, False)
    final = list(st_f)
    if bidirectional:
        st_b = init_states(params["bwd"]) if hc is None else list(hc[n:])
        st_b, out_b = _run_direction(E, params["bwd"], x, st_b, kind, nonlinearity, True)
        out = E.concat_last([out, out_b])
        final += st_b
    if batch_first:
        out = E.swap_time_batch(out)
    return out, final
