"""Traffic drivers, by the `driver` a traffic file names."""
