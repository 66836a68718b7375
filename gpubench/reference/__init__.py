"""The benchmark's plain fp32 reference: networks, train step, sliding window."""
