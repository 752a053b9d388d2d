"""Plain reference of the toy program: the same steps written out, in
float32 or, for the control, in a lower precision."""

import torch


def outputs(x: torch.Tensor, w: torch.Tensor, us: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Every step's output over ``us`` (steps, batch, dim) from the state ``x``, as float32."""
    x, w, out = x.to(dtype), w.to(dtype), []
    for u in us:
        x = torch.tanh(x @ w + u.to(dtype))
        out.append(x)
    return torch.stack(out).float()
