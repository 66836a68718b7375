"""Model summaries: a parameter table for each network of a GAN (the JAX
package's `utils/summary.py`), from `named_parameters()`; no forward pass."""

import torch


def _format_count(n: int) -> str:
    return f"{n:,}"


def network_summary(name: str, net: torch.nn.Module) -> str:
    """A table of one network's parameters."""
    lines = [
        "-" * 72,
        f"Network: {name}",
        "-" * 72,
        f"{'Layer (path)':<44}{'Shape':<18}{'Params':>10}",
        "=" * 72,
    ]
    total = 0
    for path, p in net.named_parameters():
        count = p.numel()
        total += count
        lines.append(f"{path[:43]:<44}{str(tuple(p.shape)):<18}{_format_count(count):>10}")
    lines.append("=" * 72)
    lines.append(f"Total params: {_format_count(total)}  ({total * 4 / 1024 ** 2:.2f} MB fp32)")
    lines.append("-" * 72)
    return "\n".join(lines)


def gan_summary(model) -> str:
    """Summaries of a GAN's networks (one table per network class) and each
    network's parameter count."""
    if not model.networks or any(net is None for net in model.networks.values()):
        return "(networks not built; call setup() first)"
    seen_classes = set()
    parts = []
    for name, net in model.networks.items():
        cls = type(net).__name__
        if cls not in seen_classes:
            seen_classes.add(cls)
            parts.append(network_summary(f"{name} ({cls})", net))
    parts.append("Per-network parameter counts: " + ", ".join(
        f"{name}: {_format_count(sum(p.numel() for p in net.parameters()))}"
        for name, net in model.networks.items()))
    return "\n".join(parts)
