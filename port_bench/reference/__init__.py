"""Plain references of the benchmark's configurations.

Each module holds one configuration's model in plain PyTorch (float64
unless told otherwise, TF32 off) and ``numbers(case, out, dtype)``, the
quantities that decide ``correct``.  Nothing here imports the program under
test, JAX or the JAX package: the reference works again from the inputs
what it judges and reads the program's outputs only to judge them.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
