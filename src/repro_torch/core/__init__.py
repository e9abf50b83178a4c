"""Model-side Sense pieces: balanced pruning, the §VI-F mode switch and the
§V-C dataflow choice."""
