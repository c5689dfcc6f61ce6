"""Piecewise rational-quadratic spline transforms (neural spline flows).

Twin of music_generation_tpu/core/splines.py. ConvFlow, inside the
stochastic duration predictor, runs piecewise_rational_quadratic_transform
(tails="linear"), that is unconstrained_rational_quadratic_spline
(identity outside [-tail_bound, tail_bound]). Every element takes both branches and a ``torch.where``
picks one, so no shape depends on the data.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Index of the bin holding each input; the last edge is pushed out by
    ``eps`` so an input on the right boundary lands in the last bin."""
    last = bin_locations[..., -1:] + eps
    bin_locations = torch.cat([bin_locations[..., :-1], last], dim=-1)
    return (inputs[..., None] >= bin_locations).sum(dim=-1) - 1


def _knots(unnormalized: torch.Tensor, lo: float, hi: float,
           min_bin: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cumulative knot positions [..., bins + 1], bin sizes [..., bins])
    spanning [lo, hi], each bin at least ``min_bin`` of the span."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
        inputs: torch.Tensor, unnormalized_widths: torch.Tensor,
        unnormalized_heights: torch.Tensor,
        unnormalized_derivatives: torch.Tensor, inverse: bool = False,
        left: float = 0.0, right: float = 1.0, bottom: float = 0.0,
        top: float = 1.0, min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
        min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
        min_derivative: float = DEFAULT_MIN_DERIVATIVE):
    """Monotonic RQ spline on the interval; inputs assumed inside
    [left, right] (or [bottom, top] when inverse). Returns (outputs,
    logabsdet)."""
    num_bins = unnormalized_widths.shape[-1]
    cumwidths, widths = _knots(unnormalized_widths, left, right,
                               min_bin_width)
    cumheights, heights = _knots(unnormalized_heights, bottom, top,
                                 min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = bin_idx.clamp(0, num_bins - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths)
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights)
    input_heights = take(heights)
    input_delta = take(heights / widths)
    input_derivatives = take(derivatives[..., :-1])
    input_derivatives_plus_one = take(derivatives[..., 1:])
    slope_sum = (input_derivatives + input_derivatives_plus_one
                 - 2 * input_delta)

    if inverse:
        shifted = inputs - input_cumheights
        a = shifted * slope_sum + input_heights * (input_delta
                                                   - input_derivatives)
        b = input_heights * input_derivatives - shifted * slope_sum
        c = -input_delta * shifted
        discriminant = b ** 2 - 4 * a * c
        # float32 rounding can take it just below zero
        root = (2 * c) / (-b - torch.sqrt(discriminant.clamp(min=0.0)))
        outputs = root * input_bin_widths + input_cumwidths
        theta = root
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    denominator = input_delta + slope_sum * theta_one_minus_theta
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_plus_one * theta ** 2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2)
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    if inverse:
        return outputs, -logabsdet
    numerator = input_heights * (input_delta * theta ** 2
                                 + input_derivatives * theta_one_minus_theta)
    return input_cumheights + numerator / denominator, logabsdet


def unconstrained_rational_quadratic_spline(
        inputs: torch.Tensor, unnormalized_widths: torch.Tensor,
        unnormalized_heights: torch.Tensor,
        unnormalized_derivatives: torch.Tensor, inverse: bool = False,
        tail_bound: float = 5.0,
        min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
        min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
        min_derivative: float = DEFAULT_MIN_DERIVATIVE):
    """RQ spline with identity linear tails outside [-tail_bound,
    tail_bound]; the boundary derivatives are pinned to 1."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1),
                                     value=constant)
    out_in, ld_in = rational_quadratic_spline(
        inputs.clamp(-tail_bound, tail_bound), unnormalized_widths,
        unnormalized_heights, unnormalized_derivatives, inverse=inverse,
        left=-tail_bound, right=tail_bound, bottom=-tail_bound,
        top=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    return (torch.where(inside, out_in, inputs),
            torch.where(inside, ld_in, torch.zeros_like(ld_in)))



def piecewise_rational_quadratic_transform(
        inputs: torch.Tensor, unnormalized_widths: torch.Tensor,
        unnormalized_heights: torch.Tensor,
        unnormalized_derivatives: torch.Tensor, inverse: bool = False,
        tails: Optional[str] = None, tail_bound: float = 5.0):
    """The spline on [0, 1], or with ``tails="linear"`` the unconstrained
    one with identity tails outside [-tail_bound, tail_bound]."""
    if tails == "linear":
        return unconstrained_rational_quadratic_spline(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, inverse=inverse, tail_bound=tail_bound)
    return rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=inverse)
