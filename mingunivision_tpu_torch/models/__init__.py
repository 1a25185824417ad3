"""Model modules: Bailing-MoE LLM, RF head, ViT substrate, MingTok."""
