"""The trainer lifecycle protocol (reference model_abstraction.py:4-37;
the port's copy of color_neus_tpu/models/protocol.py).

The lifecycle lives on the experiment runtime (runtime.TrainLoop), not on
an nn.Module; this Protocol pins that surface down structurally
(runtime_checkable), so another trainer can enter through the MODEL
registry with the same contract.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable


@runtime_checkable
class TrainerModule(Protocol):
    """The lifecycle surface of a trainer (model_abstraction.py's names)."""

    def training_step(self) -> dict:
        """Advance one (bundled) optimisation step; the metric aux dict."""
        ...

    def validation_step(self, step: int) -> None:
        """Render and score a held-out view (validate_image)."""
        ...

    def compute_loss(self, aux: dict) -> float:
        """The scalar loss of a step's aux (NeuS_Trainer.py:129-171)."""
        ...

    def on_train_finished(self, step: int) -> None:
        """Flush the accumulated train losses."""
        ...

    def on_val_finished(self, step: int) -> None:
        """Flush the accumulated validation metrics."""
        ...

    def testing_step(self, step: int, recon_res: int) -> Any:
        """Mesh extraction (validate_mesh; NeuS_Trainer.py:321-322)."""
        ...
