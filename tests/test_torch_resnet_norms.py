"""The reference's ``ProbeBatchNorm`` variants in the port
(``models/resnet.py``, ``norm_variant`` ``"bn16"`` and ``"folded"``):
forward logits, the new running statistics and the gradients against
the reference's, at fp32 and bf16, in training and in eval, on a
one-block-a-stage Bottleneck ResNet of width 8 with the CIFAR stem,
weights carried across by ``models/convert.py`` (a block's
``ProbeBatchNorm_{i}`` is the port's ``bn{i+1}``).  The helpers and the
tolerance (``test_torch_resnet.py``'s: 1e-5 plus twice the reference's
own distance from an fp64 run, the forward's and the gradients' apart)
are ``test_torch_resnet_variants.py``'s, where the space-to-depth stem
is held the same way; ``folded``'s running statistics come back
bit-unchanged."""

import pytest
import torch

from test_torch_resnet_variants import check_against_the_reference


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("variant", ["bn16", "folded"])
def test_forward_stats_and_backward_match_the_reference(variant, dtype,
                                                        mode):
    check_against_the_reference(variant, dtype, mode)
