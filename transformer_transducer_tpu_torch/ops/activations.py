"""The joint network's activations by config name: the native joint's
``tanh``, and an espnet joint's ``joint_activation_type`` (``tanh`` or
``relu``).  The models, both losses and the beam look them up here."""

import torch

ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}
