"""Chain initialisation: the reference's ``var_ball``.

Counterpart of ``bipymc_tpu/utils/init.py``, drawing from an explicit
generator.
"""

import torch


def var_ball(gen, var_vector, n, center=None, dtype=torch.float32,
             device="cuda"):
    """Draw ``n`` points from N(center, diag(var_vector)) on ``device``.

    gen: a ``torch.Generator`` on ``device``; var_vector: [d] variances;
    center: ball centre (default 0). Returns [n, d].
    """
    var_vector = torch.as_tensor(var_vector, dtype=dtype, device=device)
    d = var_vector.shape[-1]
    pts = torch.randn((n, d), generator=gen, dtype=dtype,
                      device=device) * torch.sqrt(var_vector)
    if center is not None:
        pts = pts + torch.as_tensor(center, dtype=dtype, device=device)
    return pts
