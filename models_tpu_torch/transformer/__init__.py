from .block import (AlbertBlock, AttentionWeights, BertBlock, GPT2Block, HiddenStates,
                    LastHiddenState, PoolerOutput, RobertaBlock, SequenceSummary,
                    TransformerBlock, TransformerInferenceHiddenState, TransformerLayer,
                    XLNetBlock)

__all__ = ["AlbertBlock", "AttentionWeights", "BertBlock", "GPT2Block", "HiddenStates",
           "LastHiddenState", "PoolerOutput", "RobertaBlock", "SequenceSummary",
           "TransformerBlock", "TransformerInferenceHiddenState", "TransformerLayer",
           "XLNetBlock"]
