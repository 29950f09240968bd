"""The dense decoder of the port: stacked layout, blocks, forward, init."""
