from connect4_tpu_torch.models.net import Connect4Net, count_params, init_net

__all__ = ["Connect4Net", "count_params", "init_net"]
