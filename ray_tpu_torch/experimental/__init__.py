from ray_tpu_torch.experimental.channel import Channel, ChannelClosed

__all__ = ["Channel", "ChannelClosed"]
