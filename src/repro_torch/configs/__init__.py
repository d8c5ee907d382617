"""One config module per ported architecture: the five LMs
(chatglm3_6b, deepseek_moe_16b, deepseek_v3_671b, gemma3_12b,
gemma3_27b), dimenet and the recsys four (bst, din, sasrec, wide_deep)."""
