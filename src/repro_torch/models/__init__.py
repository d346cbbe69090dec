"""Model definitions: the dense decoder-only transformer and xLSTM."""
