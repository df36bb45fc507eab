"""Recurrent op kernels: LSTM and GRU over whole sequences (counterparts
in paddle_tpu/ops/rnn_ops.py, where each is one ``lax.scan``).

Each op is a Python loop over time of plain torch ops on the batch-major
dense (N, T, ...) layout, products by ``torch.matmul``; autograd through
the loop is its backward (``framework/trace.py``). Work that does not
depend on the carried state is done once before the loop: the input is
split into its time steps by ``unbind`` (whose backward stacks the steps'
gradients in one op, where indexing step by step would write a zero
tensor of the whole input for each step), and the input and the
recurrent weight are split into their gate and candidate parts once, so
the per-step gradients sum before one split backward.

The GRU is fluid's, not cuDNN's: the reset gate multiplies the previous
state before the candidate's product, ``c = act(x_c + (r * h) W_c)``,
with the gates packed ``[update, reset | candidate]`` in one (H, 3H)
weight and the bias added to the projected input before both products;
``h' = u * h + (1 - u) * c``.
"""
import torch

from .registry import register_op

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _h0(ins, slot, n, h, x):
    if ins.get(slot):
        return ins[slot][0]
    return torch.zeros((n, h), dtype=x.dtype, device=x.device)


def _steps(x, reverse):
    """(T,) steps of x (N, T, D) in scan order, each (N, D)."""
    steps = x.transpose(0, 1).unbind(0)
    return steps[::-1] if reverse else steps


def _sequence(outs, reverse):
    """(N, T, D) of the per-step (N, D) outputs, back in time order."""
    return torch.stack(outs[::-1] if reverse else outs, dim=1)


@register_op("lstm_seq")
def _lstm_seq(ctx, ins, attrs):
    """ins: Input (N, T, 4H) already projected, Weight (H, 4H), Bias
    (4H), optional H0/C0 (N, H). outs: Hidden, Cell (N, T, H), LastH,
    LastC. Gate order i, f, c (candidate), o, as the reference's
    lstm_op; the bias is added after the recurrent product, as in the
    JAX op."""
    x, w = ins["Input"][0], ins["Weight"][0]
    n, _, h4 = x.shape
    h = h4 // 4
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    hp, cp = _h0(ins, "H0", n, h, x), _h0(ins, "C0", n, h, x)
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    reverse = attrs.get("is_reverse", False)
    hs, cs = [], []
    for xt in _steps(x, reverse):
        gates = xt + hp @ w
        if bias is not None:
            gates = gates + bias
        i, f, c_hat, o = gates.split(h, dim=-1)
        i, f, o = gate_act(i), gate_act(f), gate_act(o)
        cp = f * cp + i * cand_act(c_hat)
        hp = o * cell_act(cp)
        hs.append(hp)
        cs.append(cp)
    return {"Hidden": _sequence(hs, reverse), "Cell": _sequence(cs, reverse),
            "LastH": hp, "LastC": cp}


@register_op("gru_seq")
def _gru_seq(ctx, ins, attrs):
    """ins: Input (N, T, 3H) already projected, Weight (H, 3H)
    [update, reset | candidate], optional Bias (3H) and H0 (N, H).
    outs: Hidden (N, T, H), LastH (N, H). The bias is added to the whole
    input at once: the JAX op adds it to each step's input first, so the
    sums are the same."""
    x, w = ins["Input"][0], ins["Weight"][0]
    n, _, h3 = x.shape
    h = h3 // 3
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(-1)
    x_gate, x_cand = x.split([2 * h, h], dim=-1)
    w_gate, w_cand = w.split([2 * h, h], dim=-1)
    hp = _h0(ins, "H0", n, h, x)
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    reverse = attrs.get("is_reverse", False)
    hs = []
    for xg, xc in zip(_steps(x_gate, reverse), _steps(x_cand, reverse)):
        u, r = gate_act(xg + hp @ w_gate).split(h, dim=-1)
        c = cand_act(xc + (r * hp) @ w_cand)
        hp = u * hp + (1 - u) * c
        hs.append(hp)
    return {"Hidden": _sequence(hs, reverse), "LastH": hp}


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step (the reference's gru_unit_op): Input (N, 3H),
    HiddenPrev (N, H), Weight (H, 3H), optional Bias. outs: Hidden,
    Gate ([u, r, c]) and ResetHiddenPrev (r * h)."""
    x, hp, w = ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0]
    h = hp.shape[-1]
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(-1)
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    ur = gate_act(x[:, :2 * h] + hp @ w[:, :2 * h])
    u, r = ur[:, :h], ur[:, h:]
    c = cand_act(x[:, 2 * h:] + (r * hp) @ w[:, 2 * h:])
    return {"Hidden": u * hp + (1 - u) * c,
            "Gate": torch.cat([ur, c], -1), "ResetHiddenPrev": r * hp}
