"""Piecewise rational-quadratic spline flows.

Counterpart of ``text_to_speech_tpu/nn/flows.py``: the monotonic spline
bijector of Durkan et al. (2019) with linear tails, the transform inside
VITS's stochastic duration predictor.  The inputs are unconstrained network
outputs; the widths and heights go through a softmax (floored at
`min_bin_width` / `min_bin_height`), the interior knot derivatives through
a softplus (floored at `min_derivative`), and the two boundary derivatives
are the constant whose softplus is ``1 - min_derivative``, so the spline
meets the identity tails with matching slope.  Everything is computed in
float32, whatever the inputs' dtype.

The bin of a value is the count of interior knots at or below it, as the
JAX function finds it (a one-hot sum, not a search), so a value that lies
exactly on a knot goes to the bin that starts there in both packages; a
knot that the two packages compute one ulp apart can still send such a
value to the neighbouring bin.
"""

import math

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def rational_quadratic_spline(x,
                              unnormalized_widths,
                              unnormalized_heights,
                              unnormalized_derivatives,
                              *,
                              inverse = False,
                              tail_bound = 5.0,
                              min_bin_width = DEFAULT_MIN_BIN_WIDTH,
                              min_bin_height = DEFAULT_MIN_BIN_HEIGHT,
                              min_derivative = DEFAULT_MIN_DERIVATIVE):
    """x (...,); widths / heights (..., K); derivatives (..., K-1), the
    interior knots.  Returns (y, log|dy/dx|) of x's shape, float32; the
    inverse returns the log-determinant of the direction it ran."""
    x = x.float()
    K = unnormalized_widths.shape[-1]

    widths = torch.softmax(unnormalized_widths.float(), dim = -1)
    widths = min_bin_width + (1 - min_bin_width * K) * widths
    heights = torch.softmax(unnormalized_heights.float(), dim = -1)
    heights = min_bin_height + (1 - min_bin_height * K) * heights

    # the knots in [-B, B]
    B = tail_bound
    cumwidths = F.pad(torch.cumsum(widths, dim = -1), (1, 0))
    cumwidths = 2 * B * cumwidths - B
    cumheights = F.pad(torch.cumsum(heights, dim = -1), (1, 0))
    cumheights = 2 * B * cumheights - B
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]
    heights = cumheights[..., 1:] - cumheights[..., :-1]

    d = unnormalized_derivatives.float()
    boundary = torch.full_like(d[..., :1], math.log(math.expm1(1. - min_derivative)))
    derivs = min_derivative + F.softplus(torch.cat([boundary, d, boundary], dim = -1))

    inside = (x >= -B) & (x <= B)
    x_in = torch.clamp(x, -B, B)

    grid = cumheights if inverse else cumwidths
    idx = (x_in[..., None] >= grid[..., 1:-1]).sum(dim = -1, keepdim = True)
    take = lambda t: torch.gather(t, -1, idx)[..., 0]

    x_k = take(cumwidths)
    w_k = take(widths)
    y_k = take(cumheights)
    h_k = take(heights)
    d_k = take(derivs[..., :-1])
    d_k1 = take(derivs[..., 1:])
    s_k = h_k / w_k

    if not inverse:
        theta = (x_in - x_k) / w_k
        theta_1m = theta * (1 - theta)
        numerator = h_k * (s_k * theta ** 2 + d_k * theta_1m)
        denominator = s_k + (d_k1 + d_k - 2 * s_k) * theta_1m
        y = y_k + numerator / denominator
        d_num = s_k ** 2 * (d_k1 * theta ** 2 + 2 * s_k * theta_1m + d_k * (1 - theta) ** 2)
        logabsdet = torch.log(d_num) - 2 * torch.log(denominator)
    else:
        # theta solves the bin's quadratic
        t = x_in - y_k
        a = h_k * (s_k - d_k) + t * (d_k1 + d_k - 2 * s_k)
        b = h_k * d_k - t * (d_k1 + d_k - 2 * s_k)
        c = -s_k * t
        disc = torch.clamp(b ** 2 - 4 * a * c, min = 0.)
        theta = torch.clamp(2 * c / (-b - torch.sqrt(disc)), 0., 1.)
        y = theta * w_k + x_k
        theta_1m = theta * (1 - theta)
        denominator = s_k + (d_k1 + d_k - 2 * s_k) * theta_1m
        d_num = s_k ** 2 * (d_k1 * theta ** 2 + 2 * s_k * theta_1m + d_k * (1 - theta) ** 2)
        logabsdet = -(torch.log(d_num) - 2 * torch.log(denominator))

    y = torch.where(inside, y, x)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return y, logabsdet
