"""Namespace alias (the reference exposes ``paddle.nn.functional.
extension`` as a submodule): every function lives in the parent
package."""
from paddle_tpu_torch.nn.functional import *  # noqa: F401,F403
