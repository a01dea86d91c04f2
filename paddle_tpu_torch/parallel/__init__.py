"""paddle_tpu_torch.parallel — recomputation and gradient merge
(``recompute``). The mesh, sharding, collectives and pipeline of the JAX
package's ``parallel`` are not ported yet (ROADMAP A6.4)."""

from .recompute import (GradientMerge, RecomputeSequential,  # noqa: F401
                        recompute)
