"""Chat templating, image-token expansion, CFG masks and image preprocessing."""
