from .bag import Bag, BagReader, BagSampler, BagWriter
