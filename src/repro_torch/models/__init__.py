"""The port's LM stack (``repro.models``): every family's forward, loss
(differentiable by autograd) and decode step on ``nn.Module`` parameters,
behind ``repro_torch.models.api``."""
