"""Import torch model weights into paddle_tpu_torch parameters
(counterpart of paddle_tpu/utils/torch2paddle.py).

Reference parity: python/paddle/utils/torch2paddle.py — the reference
converted (lua-)torch model files into Paddle parameter files. The
capability, modernized: map a pytorch ``state_dict`` onto the parameters
of a Program's scope, with the layout transposes the two conventions
need (torch nn.Linear stores (out, in); fluid fc stores (in, out)).
The scope holds torch tensors: a weight lands on the device of the
variable it replaces.
"""
import numpy as np
import torch

__all__ = ["torch_state_dict_to_numpy", "load_torch_parameters",
           "save_net_parameters"]


def torch_state_dict_to_numpy(state_dict):
    """{name: np.ndarray} from a pytorch state_dict (tensors detached
    and moved to host)."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def load_torch_parameters(scope, state_dict, name_map,
                          transpose_linear=True, transpose_names=None):
    """Copy torch weights into ``scope``.

    name_map: {torch_param_name: paddle_var_name}. Rectangular linear/fc
    weights are transposed automatically ((out,in) -> (in,out)) when
    that is what makes the shapes agree; conv weights share the OIHW
    layout and pass through. SQUARE 2-D weights are ambiguous — both
    orientations fit — so they must be named in ``transpose_names``
    (transpose) or omitted from it (copy as-is) explicitly, otherwise
    this raises rather than guess. Returns the paddle names written.
    """
    arrays = torch_state_dict_to_numpy(state_dict)
    transpose_names = set(transpose_names or ())
    written = []
    for tname, pname in name_map.items():
        if tname not in arrays:
            raise KeyError("torch state_dict has no %r (have: %s...)"
                           % (tname, ", ".join(list(arrays)[:5])))
        arr = arrays[tname]
        existing = scope.find_var(pname)
        if existing is None:
            raise KeyError(
                "scope has no variable %r to receive %r — run the "
                "startup program (parameter init) first so shapes are "
                "known for orientation checks" % (pname, tname))
        if arr.ndim == 2:
            square = arr.shape[0] == arr.shape[1]
            if tname in transpose_names:
                arr = arr.T
            elif square and transpose_linear \
                    and tuple(existing.shape) == arr.shape:
                raise ValueError(
                    "square weight %r -> %r is orientation-ambiguous: "
                    "list it in transpose_names to transpose (torch "
                    "nn.Linear) or pass transpose_linear=False to copy "
                    "as-is (embeddings etc.)" % (tname, pname))
            elif transpose_linear \
                    and tuple(existing.shape) == arr.T.shape \
                    and tuple(existing.shape) != arr.shape:
                arr = arr.T
        if tuple(existing.shape) != arr.shape:
            raise ValueError(
                "shape mismatch importing %r -> %r: torch %s vs paddle %s"
                % (tname, pname, arr.shape, tuple(existing.shape)))
        scope.set_var(pname, torch.from_numpy(np.ascontiguousarray(arr)).to(
            existing.device))
        written.append(pname)
    return written


def save_net_parameters(state_dict, name_map, output_dir,
                        transpose_names=None):
    """Convert a torch state_dict to a parameter DIRECTORY loadable by
    ``paddle_tpu_torch.io.load_params(exe, output_dir)`` (ref
    save_net_parameters): writes ``<output_dir>/params.npz``. 2-D
    weights named in ``transpose_names`` are transposed ((out,in) ->
    (in,out) for torch nn.Linear); with no target shapes available at
    save time the transpose set must be explicit."""
    import os
    arrays = torch_state_dict_to_numpy(state_dict)
    missing = [t for t in name_map if t not in arrays]
    if missing:
        raise KeyError("torch state_dict has no %r" % (missing[0],))
    transpose_names = set(transpose_names or ())
    out = {}
    for t, p in name_map.items():
        arr = arrays[t]
        out[p] = arr.T if t in transpose_names and arr.ndim == 2 else arr
    os.makedirs(output_dir, exist_ok=True)
    np.savez(os.path.join(output_dir, "params.npz"), **out)
    return sorted(name_map.values())
