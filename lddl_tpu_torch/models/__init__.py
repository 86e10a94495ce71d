from .bert import BertConfig, BertForPretraining, spec_for_param
from .convert import flax_to_state_dict, shard_state_dict

__all__ = ['BertConfig', 'BertForPretraining', 'flax_to_state_dict',
           'shard_state_dict', 'spec_for_param']
