from .bert import BertConfig, BertForPretraining
from .convert import flax_to_state_dict, shard_state_dict

__all__ = ['BertConfig', 'BertForPretraining', 'flax_to_state_dict',
           'shard_state_dict']
