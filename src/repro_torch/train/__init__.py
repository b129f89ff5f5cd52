from repro_torch.train.loop import TrainConfig, train

__all__ = ["TrainConfig", "train"]
