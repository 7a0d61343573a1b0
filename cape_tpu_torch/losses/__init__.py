from .criterion import cape_criterion, coords_l1_loss, token_ce_loss

__all__ = ["cape_criterion", "token_ce_loss", "coords_l1_loss"]
